#!/usr/bin/env python3
"""Variants of kernel B3 (``quant_bin_sparsify``) timed side by side.

    python3 msrflute_tpu_torch/csrc/probes/quant_variants.py [name ...]

Builds ``../quant_bin.cu`` as it stands (``table_float4``: the tile table
and the 16-byte body), its earlier design ``quant_bin_scan.cu`` beside
this file (``scan_2048``: every block scans the offsets for its leaf, one
scalar a thread at a time, tiles of 2,048), and each variant of
``VARIANTS``, an edit of the source text of ``../quant_bin.cu``; one
``nvcc`` a build, all started together.  Then, on the card, holds every
build bitwise to ``quant_bin_plain`` at the DGA shape ``[10, 2,727,184]``
in 7 leaves, at BERT-base's ``[10, 109,514,298]`` in 202 leaves and on
``chip_smoke.QUANT_CASES`` at ``n_bins`` 1024, 16 and 2, and times each
on the device alone (``chip_smoke._device_ms``: L2 evicted before every
launch) at both shapes, in turns (each build once forward through the
list, then once back).  Prints one JSON line a build: its registers, the
instructions a thread of a full tile issues an element (for the 16-byte
bodies, ``ops/sass.py::vector_path``), its times, share of the byte bound
and rate.  Needs one CUDA card and ``nvcc``; nothing imports it.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
SOURCE = os.path.join(HERE, "..", "quant_bin.cu")
SCAN_SOURCE = os.path.join(HERE, "quant_bin_scan.cu")

_LOOKUP = """\
  const int2 tile = tiles[blockIdx.x];  // {leaf, tile inside the leaf}
  if (tile.x >= L) return;              // past the layout's last tile
"""
_SCAN = """\
  int2 tile = make_int2(L, 0);
  for (int l = 0, seen = 0; l < L; ++l) {
    const int64_t len = offsets[l + 1] - offsets[l];
    const int n = len > 0 ? static_cast<int>((len + kTile + 2) / kTile) : 0;
    if (static_cast<int>(blockIdx.x) < seen + n) {
      tile = make_int2(l, static_cast<int>(blockIdx.x) - seen);
      break;
    }
    seen += n;
  }
  if (tile.x >= L) return;
"""
_BODY_START = "  const int head = min("
_BODY_END = "    os[j] = q(xs[j]);\n  }\n"
_SCALAR_BODY = """\
  for (int i = threadIdx.x; i < n; i += kThreads) os[i] = q(xs[i]);
"""

#: name -> (what it tests, [(text of the source, what replaces it)]); an
#: old text of None replaces the body from _BODY_START through _BODY_END
VARIANTS = {
    "table_scalar": ("the tile table, one scalar a thread at a time",
                     [(None, _SCALAR_BODY)]),
    "scan_float4": ("every block scans the offsets, the 16-byte body",
                    [(_LOOKUP, _SCAN)]),
    "scan_scalar": ("the scan and the scalar body at tiles of 4,096",
                    [(_LOOKUP, _SCAN), (None, _SCALAR_BODY)]),
    "tile2048": ("2 loads of 16 bytes a thread, tiles of 2,048",
                 [("constexpr int kVecs = 4;", "constexpr int kVecs = 2;")]),
    "tile8192": ("8 loads of 16 bytes a thread, tiles of 8,192",
                 [("constexpr int kVecs = 4;", "constexpr int kVecs = 8;")]),
    "streaming": ("__ldcs / __stcs on the 16-byte body (evict first)",
                  [("if (i < nvec) v[u] = xv[i];",
                    "if (i < nvec) v[u] = __ldcs(xv + i);"),
                   ("if (i < nvec) ov[i] = make_float4(",
                    "if (i < nvec) __stcs(ov + i, make_float4("),
                   ("q(v[u].w));", "q(v[u].w)));")]),
}
DESCRIPTIONS = {
    "table_float4": "as shipped: the tile table, 4 loads of 16 bytes a "
                    "thread, tiles of 4,096",
    "scan_2048": "the earlier design: a scan of the offsets a block, one "
                 "scalar a thread at a time, tiles of 2,048",
    **{name: what for name, (what, _) in VARIANTS.items()}}


def _edit(text, edits, name):
    for old, new in edits:
        if old is None:
            a, b = text.find(_BODY_START), text.find(_BODY_END)
            if a < 0 or b < 0:
                raise SystemExit(f"variant {name}: body not in the source")
            text = text[:a] + new + text[b + len(_BODY_END):]
        elif old not in text:
            raise SystemExit(f"variant {name}: anchor not in the source")
        else:
            text = text.replace(old, new)
    return text


def _build(names, work):
    from msrflute_tpu_torch.ops import _build as build
    with open(SOURCE) as fh:
        text = fh.read()
    procs = {}
    for name in names:
        if name == "scan_2048":
            cu = SCAN_SOURCE
        else:
            cu = os.path.join(work, f"{name}.cu")
            with open(cu, "w") as fh:
                fh.write(_edit(text, VARIANTS.get(name, ("", []))[1], name))
        so = os.path.join(work, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = re.search(r"Used (\d+) registers", log)
        lib = ctypes.CDLL(so)
        lib.quant_bin_launch.restype = ctypes.c_int
        libs[name] = (lib, so, int(regs.group(1)) if regs else None)
    return libs


def _launcher(torch, name, lib):
    """``call(x, off, lo, hi, th, n_bins) -> out`` for one build."""
    from msrflute_tpu_torch.ops.quant_bin import _aligned_like, schedule
    P_ = ctypes.c_void_p
    tables = {}
    if name == "scan_2048":
        lib.quant_bin_launch.argtypes = [P_] * 6 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, P_]

        def call(x, off, lo, hi, th, n_bins):
            K, P = x.shape
            L = off.shape[0] - 1
            out = torch.empty_like(x)
            code = lib.quant_bin_launch(
                x.data_ptr(), out.data_ptr(), off.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), th.data_ptr(), K, P, L, -(-P // 2048) + L,
                n_bins, torch.cuda.current_stream().cuda_stream)
            assert code == 0, code
            return out
        return call
    lib.quant_bin_tile.restype = ctypes.c_int
    tile = lib.quant_bin_tile()
    lib.quant_bin_launch.argtypes = [P_] * 7 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, P_]

    def call(x, off, lo, hi, th, n_bins):
        K, P = x.shape
        L = off.shape[0] - 1
        key = (off.data_ptr(), P)
        if key not in tables:
            tables[key] = (off, schedule(off, P, tile))
        tiles = tables[key][1]
        out = _aligned_like(x)
        code = lib.quant_bin_launch(
            x.data_ptr(), out.data_ptr(), off.data_ptr(), tiles.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), th.data_ptr(), K, P, L,
            tiles.shape[0], n_bins, torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return out
    return call


def _per_element(so):
    from msrflute_tpu_torch.ops import sass
    bodies = [b for n, b in sass.functions(sass.disassemble(so)).items()
              if "quant_bin_kernel" in n]
    try:
        path = sass.vector_path(bodies[0])
    except ValueError:
        return None          # a scalar body has no 16-byte path
    return {"per_element": path["per_element"], "loads": path["loads"],
            "stores": path["stores"]}


def main(argv):
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from msrflute_tpu_torch.ops.quant_bin import quant_bin_plain
    names = ["table_float4", "scan_2048"] + [
        n for n in (argv or VARIANTS) if n not in ("table_float4",
                                                   "scan_2048")]
    with tempfile.TemporaryDirectory(prefix="quant_variants_") as work:
        libs = _build(names, work)
        calls = {n: _launcher(torch, n, libs[n][0]) for n in names}
        rec = {n: {"variant": n, "what": DESCRIPTIONS[n],
                   "registers": libs[n][2], "sass": _per_element(libs[n][1]),
                   "bitwise": True, "ms": {}} for n in names}
        gen = torch.Generator(device="cuda").manual_seed(5)
        for case, K, sizes, shift in cs.QUANT_CASES:
            t, bnd = cs._quant_odd_input(torch, gen, K, sizes, shift)
            args = cs._quant_case(torch, t, bnd, 0.7)
            for n_bins in cs.QUANT_BINS:
                want = quant_bin_plain(t, args[0].cpu(), *args[1:], n_bins)
                for n in names:
                    rec[n]["bitwise"] &= torch.equal(
                        calls[n](t, *args, n_bins), want)
        shapes = {"dga": (cs.DGA_K, cs._gru_bounds(), 100, 10),
                  "bert": (10, cs._bert_bounds(torch), 50, 10)}
        for key, (K, bounds, launches, lead) in shapes.items():
            P = bounds[-1]
            x = torch.randn((K, P), device="cuda", generator=gen)
            x *= torch.logspace(-4, -1, K, device="cuda")[:, None]
            args = cs._quant_case(torch, x, bounds, 0.7)
            want = quant_bin_plain(x, args[0].cpu(), *args[1:], 1024)
            for n in names:
                rec[n]["bitwise"] &= torch.equal(calls[n](x, *args, 1024),
                                                 want)
            del want
            torch.cuda.empty_cache()
            nbytes = cs._quant_bytes(K, P, len(bounds) - 1)
            bound_ms = nbytes / cs.PEAK_BYTES_PER_S * 1e3
            for n in names + names[::-1]:
                ms = cs._device_ms(
                    torch, lambda: calls[n](x, *args, 1024), launches, lead)
                rec[n]["ms"].setdefault(key, []).append(ms)
            for n in names:
                best = min(rec[n]["ms"][key])
                rec[n].setdefault("share", {})[key] = bound_ms / best
                rec[n].setdefault("gb_s", {})[key] = nbytes / best / 1e6
            del x, args
            torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for n in names:
        print(json.dumps({"card": card, **rec[n]}), flush=True)
    return 0 if all(r["bitwise"] for r in rec.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
