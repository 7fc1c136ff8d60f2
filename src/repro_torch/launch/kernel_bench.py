"""Check and time ``semiring_matmul`` and ``flash_decode`` alone on the card.

    PYTHONPATH=src python src/repro_torch/launch/kernel_bench.py [--label L] [--no-check]
        [--only matmul|decode]

Builds only the three libraries these two wrappers load, prints each of
their kernels' registers and spills (``-Xptxas -v``, where the tree's
``_build`` reports them), holds each kernel
against its plain version on a sweep of shapes (``semiring_matmul``: five
semirings and every storage, with and without c, aligned, ragged,
column-slice and batched operands, ``out`` aliasing ``c``, by bits;
``flash_decode``: g, hd, kv_len and S that the tiles do not divide, within
``chip_smoke.py``'s limits), then times them at the paths' shapes (median
of CUDA events): ``semiring_matmul`` at 4096³ in plus_mul beside
``torch.matmul`` (TF32 off) and in min-plus, at the phase-3 shape
(8192,128)·(128,8192) + C in min-plus, plus_mul beside ``torch.addmm``,
bf16, f16, int16 and packed words; ``flash_decode`` at the Qwen2-7B decode
shape in bf16 and f32 beside ``scaled_dot_product_attention``, each also
as device time by kernel (``torch.profiler``).  Prints one JSON line with
the card's name and power limit.  Only the wrappers'
shared interface is used, so a parent tree on PYTHONPATH runs it too:
alternate two trees in one run on one card to compare them.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys


def event_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(times)


def kernel_ms(fn, reps: int = 10) -> dict:
    """Device ms a call by kernel name, from a torch.profiler trace of reps
    calls (empty where the profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us:
            name = ev.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            out[name.split("(")[0]] = us / reps / 1e3
    return out


def matmul_operands(tag, name, shape, seed, dev):
    """(x, semiring) in a kernel's storage: the domain of the semiring,
    salted with ±inf in the float storages."""
    import torch

    from repro_torch.core import semiring as tsr

    g = torch.Generator().manual_seed(seed)
    if tag == "packed":
        return torch.randint(-(1 << 31), 1 << 31, shape, generator=g, dtype=torch.int64
                             ).to(torch.int32).to(dev), tsr.OR_AND_PACKED
    if tag == "int16":
        sr = tsr.lower_semiring(tsr.SEMIRINGS[name], torch.int16)
        if name == "or_and":
            return (torch.rand(shape, generator=g) < 0.25).to(torch.int16).to(dev), sr
        x = torch.randint(-40, 40, shape, generator=g, dtype=torch.int16)
        u = torch.rand(shape, generator=g)
        x[u < 0.02] = 32000
        x[(u > 0.5) & (u < 0.52)] = -32000
        x[u > 0.85] = sr.zero
        return x.to(dev), sr
    if tag in ("or_and_i32", "plus_mul_i32"):
        lo, hi = (-1000, 1000) if tag == "or_and_i32" else (-(1 << 31), 1 << 31)
        return (torch.randint(lo, hi, shape, generator=g, dtype=torch.int64).to(torch.int32).to(dev),
                tsr.SEMIRINGS[tag.removesuffix("_i32")])
    sr = tsr.SEMIRINGS[name]
    if name == "plus_mul":
        x = torch.rand(shape, generator=g) / shape[-1]
    elif name in ("or_and", "max_min"):
        x = (torch.rand(shape, generator=g) < 0.3).float()
    else:
        x = 1.0 + 9.0 * torch.rand(shape, generator=g)
        u = torch.rand(shape, generator=g)
        x[u < 0.05] = float("inf")
        x[u > 0.95] = float("-inf")
    dt = {None: torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[tag]
    return x.to(dt).to(dev), sr


MATMUL_SHAPES = [((257, 128), (128, 1031)), ((1000, 77), (77, 513)), ((1, 5), (5, 3)),
                 ((256, 128), (128, 384)), ((3, 40, 70), (3, 70, 130)),
                 ((200, 1000), (1000, 136))]
STORAGES = ([(None, n) for n in ("min_plus", "max_plus", "max_min", "or_and", "plus_mul")]
            + [("int16", n) for n in ("min_plus", "max_plus", "max_min", "or_and")]
            + [("packed", "or_and"), ("or_and_i32", "or_and"), ("plus_mul_i32", "plus_mul")]
            + [(t, n) for t in ("bf16", "f16")
               for n in ("min_plus", "max_plus", "max_min", "or_and", "plus_mul")])


def check_matmul(report) -> int:
    """Every storage at every shape, with and without c, then a column-slice
    view (lda != k) and ``out`` aliasing ``c``: by bits against the plain
    version.  Returns the number of cases."""
    import torch

    from repro_torch.kernels import minplus_matmul as fmm
    from repro_torch.kernels import ref
    from repro_torch.utils.bits import bits_equal

    dev, cases, stagings = torch.device("cuda"), 0, {}
    name_of = getattr(fmm, "staging_name", None)
    for tag, name in STORAGES:
        for sa, sb in MATMUL_SHAPES:
            a, sr = matmul_operands(tag, name, sa, 1, dev)
            b, _ = matmul_operands(tag, name, sb, 2, dev)
            c, _ = matmul_operands(tag, name, (*sa[:-1], sb[-1]), 3, dev)
            c0 = c.clone()
            for cc in (None, c):
                got = fmm.semiring_matmul(a, b, cc, semiring=sr)
                want = ref.semiring_matmul_ref(a, b, cc, semiring=sr)
                torch.cuda.synchronize()
                if not bits_equal(got, want):
                    raise SystemExit(f"semiring_matmul {tag} {name} {sa}@{sb} c={cc is not None}"
                                     f" != plain")
                cases += 1
            if not bits_equal(c, c0):
                raise SystemExit(f"semiring_matmul {tag} {name} wrote its c")
            # out aliasing c
            cw = c.clone()
            want = ref.semiring_matmul_ref(a, b, c, semiring=sr)
            fmm.semiring_matmul(a, b, cw, semiring=sr, out=cw)
            torch.cuda.synchronize()
            if not bits_equal(cw, want):
                raise SystemExit(f"semiring_matmul {tag} {name} {sa}@{sb} out=c != plain")
            cases += 1
        # column-slice views (lda != k): aligned (vector staging) and shifted
        # by 3 (scalar); n = 136, and n = 130 into a strided out
        for k in (77, 1000):
            wa, sr = matmul_operands(tag, name, (200, 1040), 4, dev)
            wb, _ = matmul_operands(tag, name, (k, 136), 5, dev)
            wc, _ = matmul_operands(tag, name, (200, 136), 6, dev)
            for off in (0, 3):
                av = wa[:, off:off + k]
                for bv, cv, ov in ((wb, wc, None),
                                   (wb[:, :130], wc[:, :130], torch.empty_like(wc)[:, :130])):
                    st = name_of(av, bv, cv, wc if ov is None else ov) if name_of else "-"
                    stagings[st] = stagings.get(st, 0) + 1
                    got = fmm.semiring_matmul(av, bv, cv, semiring=sr, out=ov)
                    want = ref.semiring_matmul_ref(av, bv, cv, semiring=sr)
                    torch.cuda.synchronize()
                    if not bits_equal(got, want):
                        raise SystemExit(f"semiring_matmul {tag} {name} view k={k} +{off} "
                                         f"n={bv.shape[1]} ({st}) != plain")
                    cases += 1
    report["matmul_cases"] = cases
    report["matmul_view_stagings"] = stagings
    return cases


def decode_tolerance(dtype, want):
    import math

    import torch

    if dtype == torch.float32:
        return 2e-5, 2e-5
    top = float(want.float().abs().max())
    return 2e-2, 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def check_decode(report) -> int:
    import torch

    from repro_torch.kernels import flash_decode as fdec
    from repro_torch.kernels import ref

    cases, worst = 0, 0.0
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.bfloat16, torch.float32):
        for g in (1, 2, 7, 8):
            for hd in (64, 128):
                for S in (200, 1000):
                    for kv_len in (0, 1, 63, 64, 65, S):
                        B, Hkv = 2, 2
                        q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(dtype)
                                   for sh in ((B, Hkv, g, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
                        kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
                        got = fdec.flash_decode(q, k, v, kl)
                        want = ref.flash_decode_ref(q, k, v, kv_len)
                        torch.cuda.synchronize()
                        rtol, atol = decode_tolerance(dtype, want)
                        err = float((got.float() - want.float()).abs().max())
                        worst = max(worst, err / max(atol, 1e-30))
                        if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
                            raise SystemExit(f"flash_decode {dtype} g={g} hd={hd} S={S} "
                                             f"kv_len={kv_len}: err {err} > atol {atol}")
                        cases += 1
    report["decode_cases"] = cases
    report["decode_worst_err_over_atol"] = worst
    return cases


def time_all(report, only=None) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fdec
    from repro_torch.kernels import minplus_matmul as fmm

    dev = torch.device("cuda")
    name_of = getattr(fmm, "staging_name", lambda *t: "-")
    sq = 4096
    for name in ("plus_mul", "min_plus") if only != "decode" else ():
        a, sr = matmul_operands(None, name, (sq, sq), 40, dev)
        b, _ = matmul_operands(None, name, (sq, sq), 41, dev)
        out = torch.empty_like(a)
        report[f"mm_{name}_4096"] = event_ms(
            lambda: fmm.semiring_matmul(a, b, semiring=sr, out=out), 5)
        report["mm_staging_4096"] = name_of(a, b, None, out)
        if name == "plus_mul":
            report["torch_matmul_4096"] = event_ms(lambda: torch.matmul(a, b, out=out), 5)
        del a, b, out
    n, s = 8192, 128
    phase3 = ((None, "min_plus"), (None, "plus_mul"), ("bf16", "min_plus"), ("f16", "min_plus"),
              ("int16", "min_plus"), ("packed", "or_and"))
    for tag, name in phase3 if only != "decode" else ():
        w, sr = matmul_operands(tag, name, (n, n), 1, dev)
        col, _ = matmul_operands(tag, name, (n, s), 2, dev)
        row, _ = matmul_operands(tag, name, (s, n), 3, dev)
        out = torch.empty_like(w)
        key = f"mm_phase3_{tag or 'f32'}_{name}"
        report[key] = event_ms(lambda: fmm.semiring_matmul(col, row, w, semiring=sr, out=out), 5)
        report["mm_staging_phase3"] = name_of(col, row, w, out)
        if tag is None and name == "plus_mul":
            report["torch_addmm_phase3"] = event_ms(
                lambda: torch.addmm(w, col, row, out=out), 5)
        del w, col, row, out
    B, Hkv, g, hd, S, kv_len = 8, 4, 7, 128, 32768, 32000
    gen = torch.Generator(device="cuda").manual_seed(50)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32) if only != "matmul" else ():
        q = torch.randn((B, Hkv, g, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        report[f"decode_{tag}"] = event_ms(lambda: fdec.flash_decode(q, k, v, kl), 21)
        report[f"decode_{tag}_by_kernel"] = kernel_ms(lambda: fdec.flash_decode(q, k, v, kl))
        qs = q.reshape(B, Hkv * g, 1, hd)
        ks = k[:, :kv_len].transpose(1, 2).contiguous()
        vs = v[:, :kv_len].transpose(1, 2).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)  # noqa: E731
        report[f"sdpa_{tag}"] = event_ms(sdpa, 21)
        report[f"sdpa_{tag}_by_kernel"] = kernel_ms(sdpa)
        del q, k, v, ks, vs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--no-check", action="store_true", help="time only")
    ap.add_argument("--only", choices=("matmul", "decode"), help="one of the two kernels")
    args = ap.parse_args(argv)
    import torch

    import repro_torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    report = dict(label=args.label, package=repro_torch.__file__, device=smi)
    libs = {None: ("minplus_matmul", "minplus_matmul_lowered", "flash_decode"),
            "matmul": ("minplus_matmul", "minplus_matmul_lowered"),
            "decode": ("flash_decode",)}[args.only]
    for built in _build.build_all(libs):
        print(f"built {built.path.name} in {built.seconds:.1f} s")
        for kern in getattr(_build, "kernel_infos", lambda b: [])(built):
            print(f"  {kern.name}: {kern.registers} registers, spills {kern.spill_stores} / "
                  f"{kern.spill_loads} B")
    if not args.no_check and args.only != "decode":
        print(f"checked {check_matmul(report)} semiring_matmul cases by bits", flush=True)
    if not args.no_check and args.only != "matmul":
        print(f"checked {check_decode(report)} flash_decode cases", flush=True)
    time_all(report, args.only)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
