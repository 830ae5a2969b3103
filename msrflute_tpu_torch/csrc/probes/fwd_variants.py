#!/usr/bin/env python3
"""Variants of kernel B4 (the flash-attention forward) timed side by side.

    python3 msrflute_tpu_torch/csrc/probes/fwd_variants.py [name ...]

Builds ``../flash_attention.cu`` once as it stands (``base``) and once for
each variant, an edit of the source text named in ``VARIANTS``, all
``nvcc`` runs started together; then, on the card, holds each build's B4 to
the plain version (largest error over the largest value, and two launches
bitwise equal) at the RingLM path's ``[40, 1023, 4, 32]`` causal and at an
offset case with fully masked rows, and times each at that shape and at
the eval step's ``[16, 1023, 4, 32]`` with CUDA events, in turns (each
build once forward through the list, then once back).  Prints one JSON
line a build: registers, local memory and blocks an SM at D = 32, the
errors, the times and the share of the f32 bound (as ``chip_smoke.py``
counts it).  Needs one CUDA card and ``nvcc``; nothing imports it.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
SOURCE = os.path.join(HERE, "..", "flash_attention.cu")

_RESCALE = """\
    __syncwarp();  // the warp reads only the p rows and corr it wrote
#pragma unroll
    for (int i = 0; i < T::kRows; ++i) {
      const float c = slot[own.row + i * T::kRowLanes];
#pragma unroll
      for (int j = 0; j < T::kCols; ++j) {
        float4& a = acc[i][j];
        a.x *= c, a.y *= c, a.z *= c, a.w *= c;
      }
    }
"""

#: name -> [(text of the source, what replaces it)]
VARIANTS = {
    # three blocks an SM at D <= 32 (at most 80 registers a thread)
    "blocks3": [(
        "__global__ void __launch_bounds__(kThreads, Layout<DT>::kMinBlocks)\n"
        "flash_fwd_kernel(",
        "__global__ void __launch_bounds__(kThreads, DT <= 32 ? 3 : 1)\n"
        "flash_fwd_kernel(")],
    # rescale only when a row's max grows by more than 8 (log2 units, so
    # p <= 256), and skip the accumulators' rescale when no row of the warp
    # grew
    "lazy": [
        ("""    const float m_new = fmaxf(m2[x], mt * scale2);
    const float corr = fast_exp2(m2[x] - m_new);
""", """    const bool grow = mt * scale2 > m2[x] + 8.0f;
    const float m_new = grow ? mt * scale2 : m2[x];
    const float corr = grow ? fast_exp2(m2[x] - m_new) : 1.0f;
"""),
        ("""    float* Pt = Ps + at.own * kScoreStride + at.streamed;
""", """    float* Pt = Ps + at.own * kScoreStride + at.streamed;
    const float o0 = m2[0], o1 = m2[1], o2 = m2[2], o3 = m2[3];
"""),
        (_RESCALE, """    __syncwarp();
    if (__any_sync(0xffffffffu, o0 != m2[0] || o1 != m2[1] ||
                                    o2 != m2[2] || o3 != m2[3])) {
""" + _RESCALE.split("\n", 1)[1] + "    }\n")],
}
VARIANTS["blocks3_lazy"] = VARIANTS["blocks3"] + VARIANTS["lazy"]


def _build(names, work):
    sys.path.insert(0, REPO)
    from msrflute_tpu_torch.ops import _build as build
    with open(SOURCE) as fh:
        text = fh.read()
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS.get(name, []):
            if old not in src:
                raise SystemExit(f"variant {name}: anchor not in the source")
            src = src.replace(old, new)
        cu = os.path.join(work, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = os.path.join(work, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.flash_fwd_launch.argtypes = ([ctypes.c_void_p] * 5 +
                                         [ctypes.c_int] * 8 +
                                         [ctypes.c_float, ctypes.c_void_p])
        lib.flash_fwd_launch.restype = ctypes.c_int
        lib.flash_kernel_info.argtypes = [ctypes.c_int, ctypes.c_int] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        lib.flash_kernel_info.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv):
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from msrflute_tpu_torch.ops import flash_attention as fa
    names = ["base"] + [n for n in (argv or VARIANTS) if n != "base"]
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="fwd_variants_") as work:
        libs = _build(names, work)

        def fwd(lib, q, k, v, causal, qo, ko):
            B, Lq, H, D = q.shape
            out = torch.empty_like(q)
            lse = torch.empty((B, H, Lq), device="cuda")
            code = lib.flash_fwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, Lq, k.shape[1], H, D, int(causal), qo, ko,
                1.0 / D ** 0.5, torch.cuda.current_stream().cuda_stream)
            assert code == 0, code
            return out, lse

        shapes = {"main": cs.FLASH_MAIN,
                  "eval": (cs.FLASH_EVAL_B,) + cs.FLASH_MAIN[1:],
                  "masked_rows": (2, 100, 150, 2, 32, True, 0, 30)}
        inputs = {key: (cs._flash_case(torch, *shape[:5], seed=i)[:3], shape)
                  for i, (key, shape) in enumerate(shapes.items())}
        rec = {n: {"variant": n, "ms": {}} for n in names}
        for n in names:
            regs, local, blocks = (ctypes.c_int() for _ in range(3))
            libs[n].flash_kernel_info(0, 32, ctypes.byref(regs),
                                      ctypes.byref(local),
                                      ctypes.byref(blocks))
            rec[n].update(registers_d32=regs.value, local_bytes_d32=local.value,
                          blocks_per_sm_d32=blocks.value, rel_err={})
            for key in ("main", "masked_rows"):
                (q, k, v), shape = inputs[key]
                causal, qo, ko = shape[5:]
                out, lse = fwd(libs[n], q, k, v, causal, qo, ko)
                again = fwd(libs[n], q, k, v, causal, qo, ko)
                p_out, p_lse = fa.attention_lse_plain(q, k, v, causal, qo, ko)
                dead = p_lse == fa.NEG
                ok = (torch.equal(again[0], out) and
                      torch.equal(again[1], lse) and
                      torch.equal(lse == fa.NEG, dead) and
                      bool((out.transpose(1, 2)[dead] == 0).all()))
                rec[n]["rel_err"][key] = max(
                    cs._rel_err(torch, out, p_out),
                    cs._rel_err(torch, lse[~dead], p_lse[~dead]))
                rec[n].setdefault("bitwise_and_masked_rows_ok", True)
                rec[n]["bitwise_and_masked_rows_ok"] &= ok
        for key in ("main", "eval"):
            (q, k, v), shape = inputs[key]
            causal, qo, ko = shape[5:]
            pairs = cs._visible_pairs(torch, *shape[:4], causal, qo, ko)
            bound_ms = 2 * 2 * shape[4] * pairs / cs.PEAK_F32_FLOPS * 1e3
            for n in names + names[::-1]:
                ms = cs._time_ms(torch, lambda: fwd(libs[n], q, k, v, causal,
                                                    qo, ko), iters=50)
                rec[n]["ms"].setdefault(key, []).append(ms)
                rec[n].setdefault("share_of_bound", {})[key] = \
                    bound_ms / min(rec[n]["ms"][key])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for n in names:
        print(json.dumps({"card": card, **rec[n]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
