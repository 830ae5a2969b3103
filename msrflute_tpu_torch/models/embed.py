"""A table lookup whose backward is deterministic on the card.

PyTorch's CUDA embedding backward sums a row's gradients with atomics
past 3,072 indices, so two runs differ in the last bits; the port's
character models avoid it with a one-hot product (:func:`.nlp.embed_lookup`),
which is exact but costs ``N x V`` of memory and a GEMM.  At NRMS's
40,000 words and 26,400 tokens a client step, or BERT's 30,522 and 2,048,
that product does not fit or does not pay, so :func:`embed_gather` is a
gather forward and a sorted segmented sum backward:

- the ids are sorted (stable), the output gradient's rows are gathered in
  that order, and ``torch.segment_reduce`` sums each run of equal ids in
  turn (one thread a run and column on the card, no atomics);
- the sums land in a zero table by ``index_copy_`` at the unique ids.

Under ``torch.func.vmap`` over K clients the tables fold into one
``[K * V, D]`` table and the ids are offset by ``k * V``, so one launch
serves the round; the two ``autograd.Function`` s carry the vmap rules.
"""

from __future__ import annotations

import torch


def _segment_sum(ids: torch.Tensor, grad: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """``zeros[rows, D]`` with ``grad[i]`` summed into row ``ids[i]``, in
    the ids' stable sorted order."""
    sorted_ids, perm = torch.sort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(sorted_ids, return_counts=True)
    sums = torch.segment_reduce(grad.index_select(0, perm), "sum",
                                lengths=counts, axis=0)
    out = torch.zeros((rows, grad.shape[-1]), dtype=grad.dtype,
                      device=grad.device)
    return out.index_copy_(0, uniq, sums)


def _fold(info, in_dims, table, ids):
    """Client axes to the front; K tables into one, ids offset by k * V."""
    K = info.batch_size
    ids = (ids.movedim(in_dims[1], 0) if in_dims[1] is not None
           else ids.expand(K, *ids.shape))
    if in_dims[0] is None:
        return table, ids.reshape(-1), ids.shape
    table = table.movedim(in_dims[0], 0)
    V = table.shape[1]
    offs = torch.arange(K, device=ids.device).view(
        K, *([1] * (ids.dim() - 1))) * V
    return table.reshape(K * V, -1), (ids + offs).reshape(-1), ids.shape


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(table, ids):
        return table.index_select(0, ids)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, ids = inputs
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return _GatherBwd.apply(ids, grad.contiguous(), ctx.rows), None

    @staticmethod
    def vmap(info, in_dims, table, ids):
        flat, fids, shape = _fold(info, in_dims, table, ids)
        out = _Gather.apply(flat, fids)
        return out.reshape(*shape, out.shape[-1]), 0


class _GatherBwd(torch.autograd.Function):
    """First order only: the federated update takes no second
    derivative."""

    @staticmethod
    def forward(ids, grad, rows):
        return _segment_sum(ids, grad, rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("embed_gather has no second derivative")

    @staticmethod
    def vmap(info, in_dims, ids, grad, rows):
        K = info.batch_size
        ids = (ids.movedim(in_dims[0], 0) if in_dims[0] is not None
               else ids.expand(K, *ids.shape))
        grad = (grad.movedim(in_dims[1], 0) if in_dims[1] is not None
                else grad.expand(K, *grad.shape))
        offs = torch.arange(K, device=ids.device)[:, None] * rows
        out = _GatherBwd.apply((ids + offs).reshape(-1),
                               grad.reshape(-1, grad.shape[-1]), K * rows)
        return out.reshape(K, rows, -1), 0


def embed_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (``ids`` any shape of non-negative integers below
    ``V``) -> ``[*ids.shape, D]``, with a deterministic backward."""
    out = _Gather.apply(table, ids.reshape(-1).long())
    return out.reshape(*ids.shape, table.shape[-1])
