"""Why K4's f32 output can leave ``K4_TOL``: a probe of the worst element.

    python3 -m whisper_tpu_torch.utils.k4_f32_flip [SEEDS]   # repository root, one CUDA card

At chip_smoke.py's "cross-f32" case (q (64, 20, 1, 64) f32 over 1500 int8
keys), for each seed (default 32) it runs the kernel and its plain version
on the same inputs and, at the element of largest error, recomputes that
row's p * v_scale in f64. It lists the keys whose f32 p * v_scale (the value
``pv_out`` rounds to bf16) lies within 32 f32 ulps of a bf16 rounding
midpoint, with the f64 value's distance from the same midpoint, and fits the
row's 64 output errors by least squares to those keys' flips (one bf16 ulp
of p * v_scale times the key's v codes, in the direction opposite to the
plain version's rounding), and prints the keys fitted at 0.5 or more. A
coefficient of 1 and a residual at f32 noise say the error is that flip and
nothing else. It also prints the flip term
that chip_smoke.py adds to the f32 check at that element.
"""

from __future__ import annotations

import sys

import torch


def _f32_ulp(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 24)


def probe(seed: int, log) -> None:
    import chip_smoke as smoke
    from ..kernels.cross_attention_int8 import (cross_attention_int8,
                                                cross_attention_int8_reference)
    from ..model.quant import QuantKV, qk_logits

    name, bsz, h, tq, c, n_past, dtype = next(x for x in smoke.K4_CASES if x[0] == "cross-f32")
    args = smoke.k4_inputs(smoke.case_generator(name, seed), bsz, h, tq, c, n_past, dtype)
    q, k8, ks, v8, vs, _ = args
    out = cross_attention_int8(*args)
    ref = cross_attention_int8_reference(*args)
    diff = out - ref
    atol, rtol = smoke.K4_TOL[dtype]
    old_ok = bool((diff.abs() <= atol + rtol * ref.abs()).all())
    flat = int(diff.abs().argmax())
    b, hh, t, d = (int(i) for i in torch.unravel_index(torch.tensor(flat), diff.shape))
    # the plain version's own f32 p * v_scale, the value pv_out rounds
    x32 = (torch.softmax(qk_logits(q, QuantKV(k8, ks)), dim=-1) * vs.unsqueeze(-2))[b, hh, t]
    lg64 = (q[b, hh, t].double() @ k8[b, hh].double()) * ks[b, hh].double()
    x64 = torch.softmax(lg64, dim=-1) * vs[b, hh].double()
    lo = (x32.view(torch.int32) & -65536).view(torch.float32)  # truncated to bf16
    ulp16 = smoke.bf16_ulp(x32)
    mid = lo.double() + ulp16.double() / 2
    ulp32 = _f32_ulp(x32).double()
    dist32 = (x32.double() - mid) / ulp32
    dist64 = (x64 - mid) / ulp32
    cand = torch.nonzero(dist32.abs() <= 32).flatten()
    term = smoke.k4_flip_term(*args)[b, hh, t, d].item()
    log(f"[k4-flip] seed {seed}: max_abs_err {diff.abs().max().item():.3e} at (b {b}, h {hh}, "
        f"t {t}, d {d}); K4_TOL alone: {'within' if old_ok else 'OUTSIDE'}; the element's "
        f"flip term {term:.3e}; {len(cand)} key(s) within 32 f32 ulps of a bf16 midpoint")
    if len(cand) == 0:
        return
    # a flip moves the row by -(+)1 bf16 ulp where the plain version rounded up (down)
    sign = torch.where(x32[cand].double() > mid[cand], -1.0, 1.0)
    cols = sign[None, :] * ulp16[cand].double()[None, :] * v8[b, hh][:, cand].double()
    row = diff[b, hh, t].double()
    coef = torch.linalg.lstsq(cols.cpu(), row.cpu()[:, None]).solution.flatten()
    resid = (row.cpu() - cols.cpu() @ coef).abs().max().item()
    for i, key in enumerate(cand.tolist()):
        if abs(coef[i].item()) < 0.5:
            continue
        log(f"[k4-flip]   key {key}: p {x64[key].item() / vs[b, hh, key].item():.4e}, "
            f"p * v_scale f64 {x64[key].item():.9e}, f32 {x32[key].item():.9e}; from the bf16 "
            f"midpoint {mid[key].item():.9e}: f32 {dist32[key].item():+.2f} ulps, f64 "
            f"{dist64[key].item():+.2f} ulps; v code at d {int(v8[b, hh, d, key])}; a flip "
            f"moves out[d] by {cols[d, i].item():+.3e}; fitted coefficient {coef[i].item():+.4f}")
    log(f"[k4-flip]   row error max {row.abs().max().item():.3e}, residual after the fitted "
        f"flips {resid:.3e}; {int((coef.abs() < 0.5).sum())} other key(s) fitted below 0.5")


def main() -> None:
    import chip_smoke as smoke

    card = smoke.phase_device()
    from ..kernels import build

    build.build_all(("cross_attention_int8",))
    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    for seed in range(seeds):
        probe(seed, smoke.log)
    smoke.log(f"[k4-flip] {card}")


if __name__ == "__main__":
    main()
