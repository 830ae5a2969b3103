#!/usr/bin/env python3
"""Variants of the tensor-core arms of kernels B4, B5 and B6 (bfloat16
storage) timed side by side.

    python3 msrflute_tpu_torch/csrc/probes/tc_variants.py [name ...]

Builds ``../flash_attention.cu`` once as it stands (``base``) and once for
each variant, an edit of the source text named in ``VARIANTS``, all
``nvcc`` runs started together; then, on the card, holds each build's
bfloat16 B4, B5 and B6 to the plain versions (largest error over the
largest value within ``chip_smoke.FLASH16_TOL``, lse within
``FLASH_FWD_TOL``, and two launches bitwise equal) at the RingLM path's
``[40, 1023, 4, 32]`` causal and at a ragged offset case with fully masked
rows, and times each on the device alone (``chip_smoke._device_ms``) at
that shape (B4, B5 and B6) and at the eval step's ``[16, 1023, 4, 32]``
(B4), in turns (each build once forward through the list, then once
back).  Prints one JSON line a build: registers, local memory and blocks
an SM of the three instances at D = 32, B5's registers and spills at
every width (``ptxas``), the errors and the times.  Needs
one CUDA card and ``nvcc``; nothing imports it.
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

#: B5 at 32 keys a pass at every width, and at 64 at every width
_DQ_C32 = ("static constexpr int kDqChunk = DT <= 32 ? 64 : 32;",
           "static constexpr int kDqChunk = 32;")
_DQ_C64 = ("static constexpr int kDqChunk = DT <= 32 ? 64 : 32;",
           "static constexpr int kDqChunk = 64;")
_DQ_BLOCKS3 = ("static constexpr int kDqBlocks = DT <= 64 ? 4 : 2;",
               "static constexpr int kDqBlocks = DT <= 32 ? 3 : 2;")
#: B5 reading its warp's Q and dO A fragments by ldmatrix every pass, as
#: its first design did, instead of holding them in registers
_DQ_RELOAD = ("""      tc_product_held<DT, kN>(s, qa, Ks + nk);
      tc_product_held<DT, kN>(dp, ga, Vs + nk);""",
              """      tc_product_nk<DT, kN>(s, Qs + own, Ks + nk);
      tc_product_nk<DT, kN>(dp, Gs + own, Vs + nk);""")
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
    # B5: 32 keys a pass; 64 at every width; three blocks an SM; its
    # first design, Q and dO read every pass, at 32 keys a pass
    "dq_c32": [_DQ_C32],
    "dq_c64": [_DQ_C64],
    "dq_blocks3": [_DQ_BLOCKS3],
    "dq_reload_c32": [_DQ_RELOAD, _DQ_C32],
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
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: anchor not once in the "
                                 "source")
            src = src.replace(old, new)
        cu = os.path.join(work, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = os.path.join(work, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        logs[name] = log
        lib = ctypes.CDLL(so)
        lib.flash_fwd_launch_bf16.argtypes = [ctypes.c_void_p] * 5 + _TAIL
        lib.flash_dq_launch_bf16.argtypes = [ctypes.c_void_p] * 8 + _TAIL
        lib.flash_dkv_launch_bf16.argtypes = [ctypes.c_void_p] * 9 + _TAIL
        lib.flash_kernel_info.argtypes = [ctypes.c_int, ctypes.c_int] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        for fn in (lib.flash_fwd_launch_bf16, lib.flash_dq_launch_bf16,
                   lib.flash_dkv_launch_bf16, lib.flash_kernel_info):
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs, logs


def main(argv):
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from msrflute_tpu_torch.ops import flash_attention as fa
    names = ["base"] + [n for n in (argv or VARIANTS) if n != "base"]
    dt = torch.bfloat16
    tol = cs.FLASH16_TOL["bfloat16"]
    with tempfile.TemporaryDirectory(prefix="tc_variants_") as work:
        libs, logs = _build(names, work)
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

        def dq(lib, q, k, v, g, lse, delta, glse, causal, qo, ko):
            B, Lq, H, D = q.shape
            out = torch.empty_like(q)
            code = lib.flash_dq_launch_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), glse.data_ptr(),
                out.data_ptr(), B, Lq, k.shape[1], H, D, int(causal), qo, ko,
                1.0 / D ** 0.5, stream())
            assert code == 0, code
            return out

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
                           fa.attention_dkv_plain(*bwd),
                           fa.attention_dq_plain(*bwd))
        rec = {n: {"variant": n, "ms": {}, "rel_err": {}} for n in names}
        for n in names:
            for which, key in enumerate(("fwd", "dq", "dkv")):
                regs, local, blocks = (ctypes.c_int() for _ in range(3))
                libs[n].flash_kernel_info(which + 3, 32, ctypes.byref(regs),
                                          ctypes.byref(local),
                                          ctypes.byref(blocks))
                rec[n][key] = {
                    "registers": regs.value, "local_bytes": local.value,
                    "blocks_per_sm": blocks.value}
            # B5's instances at every width: registers and spills
            rec[n]["dq_ptxas"] = {
                name: r for name, r in cs.ptxas_reports(logs[n]).items()
                if name.startswith("flash_dq_tc_kernel")
                and "bfloat16" in name}
            ok = True
            for key in ("main", "ragged", "masked_rows"):
                q, k, v, causal, qo, ko, p_out, p_lse, bwd, p_dkv, p_dq = \
                    inputs[key]
                out, lse = fwd(libs[n], q, k, v, causal, qo, ko)
                again = fwd(libs[n], q, k, v, causal, qo, ko)
                dk, dv = dkv(libs[n], *bwd)
                dk2, dv2 = dkv(libs[n], *bwd)
                dq1, dq2 = dq(libs[n], *bwd), dq(libs[n], *bwd)
                dead = p_lse == fa.NEG
                live = ~dead
                err = {"out": cs._rel_err(torch, out.float(), p_out.float()),
                       "lse": cs._rel_err(torch, lse[live], p_lse[live]),
                       "dq": cs._rel_err(torch, dq1.float(), p_dq.float()),
                       "dk": cs._rel_err(torch, dk.float(),
                                         p_dkv[0].float()),
                       "dv": cs._rel_err(torch, dv.float(),
                                         p_dkv[1].float())}
                rec[n]["rel_err"][key] = err
                ok &= (torch.equal(again[0], out) and
                       torch.equal(again[1], lse) and
                       torch.equal(dk2, dk) and torch.equal(dv2, dv) and
                       torch.equal(dq1, dq2) and
                       torch.equal(lse == fa.NEG, dead) and
                       bool((out.transpose(1, 2)[dead] == 0).all()) and
                       max(err["out"], err["dq"], err["dk"],
                           err["dv"]) <= tol and
                       err["lse"] <= cs.FLASH_FWD_TOL)
            rec[n]["checks_ok"] = ok
        for key, calls in (("fwd_main", "main"), ("fwd_eval", "eval"),
                           ("dq_main", "main"), ("dkv_main", "main")):
            q, k, v, causal, qo, ko, _, _, bwd, _, _ = inputs[calls]
            for n in names + names[::-1]:
                if key.startswith("fwd"):
                    fn = lambda: fwd(libs[n], q, k, v, causal, qo, ko)  # noqa
                elif key.startswith("dq"):
                    fn = lambda: dq(libs[n], *bwd)  # noqa
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
