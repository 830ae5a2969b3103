#!/usr/bin/env python3
"""Variants of the tensor-core arms of kernels B4 and B6 (bfloat16 storage)
timed side by side.

    python3 msrflute_tpu_torch/csrc/probes/tc_variants.py [name ...]

Builds ``../flash_attention.cu`` once as it stands (``base``) and once for
each variant, an edit of the source text named in ``VARIANTS``, all
``nvcc`` runs started together; then, on the card, holds each build's
bfloat16 B4 and B6 to the plain versions (largest error over the largest
value within ``chip_smoke.FLASH16_TOL``, lse within ``FLASH_FWD_TOL``, and
two launches bitwise equal) at the RingLM path's ``[40, 1023, 4, 32]``
causal and at a ragged offset case with fully masked rows, and times each
on the device alone (``chip_smoke._device_ms``) at that shape (B4 and B6)
and at the eval step's ``[16, 1023, 4, 32]`` (B4), in turns (each build
once forward through the list, then once back).  Prints one JSON line a
build: registers, local memory and blocks an SM of both instances at
D = 32, the errors and the times.  Needs one CUDA card and ``nvcc``;
nothing imports it.
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

#: name -> [(text of the source, what replaces it)]
VARIANTS = {
    # B4: three blocks an SM at D <= 32 (up to 168 registers a thread)
    "fwd_blocks3": [(
        "static constexpr int kFwdBlocks = DT <= 64 ? 4 : 2;",
        "static constexpr int kFwdBlocks = DT <= 32 ? 3 : 2;")],
    # B6: a whole 64-query tile a pass, three blocks an SM
    "dkv_c64": [
        ("constexpr int kTcChunk = 32;", "constexpr int kTcChunk = 64;"),
        ("static constexpr int kDkvBlocks = DT <= 32 ? 4 : 2;",
         "static constexpr int kDkvBlocks = DT <= 32 ? 3 : 2;")],
}

_TAIL = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


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
        lib.flash_fwd_launch_bf16.argtypes = [ctypes.c_void_p] * 5 + _TAIL
        lib.flash_dkv_launch_bf16.argtypes = [ctypes.c_void_p] * 9 + _TAIL
        lib.flash_kernel_info.argtypes = [ctypes.c_int, ctypes.c_int] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        for fn in (lib.flash_fwd_launch_bf16, lib.flash_dkv_launch_bf16,
                   lib.flash_kernel_info):
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv):
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from msrflute_tpu_torch.ops import flash_attention as fa
    names = ["base"] + [n for n in (argv or VARIANTS) if n != "base"]
    dt = torch.bfloat16
    tol = cs.FLASH16_TOL["bfloat16"]
    with tempfile.TemporaryDirectory(prefix="tc_variants_") as work:
        libs = _build(names, work)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa

        def fwd(lib, q, k, v, causal, qo, ko):
            B, Lq, H, D = q.shape
            out = torch.empty_like(q)
            lse = torch.empty((B, H, Lq), device="cuda")
            code = lib.flash_fwd_launch_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, Lq, k.shape[1], H, D, int(causal), qo, ko,
                1.0 / D ** 0.5, stream())
            assert code == 0, code
            return out, lse

        def dkv(lib, q, k, v, g, lse, delta, glse, causal, qo, ko):
            B, Lq, H, D = q.shape
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            code = lib.flash_dkv_launch_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), glse.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, Lq, k.shape[1], H, D,
                int(causal), qo, ko, 1.0 / D ** 0.5, stream())
            assert code == 0, code
            return dk, dv

        shapes = {"main": cs.FLASH_MAIN,
                  "eval": (cs.FLASH_EVAL_B,) + cs.FLASH_MAIN[1:],
                  "ragged": (2, 150, 170, 2, 32, True, 37, 11),
                  "masked_rows": (2, 100, 150, 2, 32, True, 0, 30)}
        inputs = {}
        for i, (key, shape) in enumerate(shapes.items()):
            q, k, v, g, g_lse = cs._flash16_case(torch, dt, *shape[:5], i)
            causal, qo, ko = shape[5:]
            p_out, p_lse = fa.attention_lse_plain(q, k, v, causal, qo, ko)
            if key == "main":
                g_lse.zero_()
            g_lse = torch.where(p_lse == fa.NEG, 0.0, g_lse)
            bwd = (q, k, v, g, p_lse, fa.attention_delta(p_out, g), g_lse,
                   causal, qo, ko)
            inputs[key] = (q, k, v, causal, qo, ko, p_out, p_lse, bwd,
                           fa.attention_dkv_plain(*bwd))
        rec = {n: {"variant": n, "ms": {}, "rel_err": {}} for n in names}
        for n in names:
            for which in (0, 2):
                regs, local, blocks = (ctypes.c_int() for _ in range(3))
                libs[n].flash_kernel_info(which + 3, 32, ctypes.byref(regs),
                                          ctypes.byref(local),
                                          ctypes.byref(blocks))
                rec[n]["fwd" if which == 0 else "dkv"] = {
                    "registers": regs.value, "local_bytes": local.value,
                    "blocks_per_sm": blocks.value}
            ok = True
            for key in ("main", "ragged", "masked_rows"):
                q, k, v, causal, qo, ko, p_out, p_lse, bwd, p_dkv = \
                    inputs[key]
                out, lse = fwd(libs[n], q, k, v, causal, qo, ko)
                again = fwd(libs[n], q, k, v, causal, qo, ko)
                dk, dv = dkv(libs[n], *bwd)
                dk2, dv2 = dkv(libs[n], *bwd)
                dead = p_lse == fa.NEG
                live = ~dead
                err = {"out": cs._rel_err(torch, out.float(), p_out.float()),
                       "lse": cs._rel_err(torch, lse[live], p_lse[live]),
                       "dk": cs._rel_err(torch, dk.float(),
                                         p_dkv[0].float()),
                       "dv": cs._rel_err(torch, dv.float(),
                                         p_dkv[1].float())}
                rec[n]["rel_err"][key] = err
                ok &= (torch.equal(again[0], out) and
                       torch.equal(again[1], lse) and
                       torch.equal(dk2, dk) and torch.equal(dv2, dv) and
                       torch.equal(lse == fa.NEG, dead) and
                       bool((out.transpose(1, 2)[dead] == 0).all()) and
                       max(err["out"], err["dk"], err["dv"]) <= tol and
                       err["lse"] <= cs.FLASH_FWD_TOL)
            rec[n]["checks_ok"] = ok
        for key, calls in (("fwd_main", "main"), ("fwd_eval", "eval"),
                           ("dkv_main", "main")):
            q, k, v, causal, qo, ko, _, _, bwd, _ = inputs[calls]
            for n in names + names[::-1]:
                if key.startswith("fwd"):
                    fn = lambda: fwd(libs[n], q, k, v, causal, qo, ko)  # noqa
                else:
                    fn = lambda: dkv(libs[n], *bwd)  # noqa
                rec[n]["ms"].setdefault(key, []).append(
                    cs._device_ms(torch, fn))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for n in names:
        print(json.dumps({"card": card, **rec[n]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
