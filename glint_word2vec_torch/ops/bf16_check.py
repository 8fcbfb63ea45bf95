"""The check of the fused step's bf16 forms against the plain step on the card.

``chip_smoke.py`` (phase 3b) and the CUDA tests of ``tests/test_torch_kernel.py`` both
call :func:`check_form`, which holds the kernel to two limits.

1. The touched rows, elementwise: the kernel, the plain step with the same dtypes and a
   float64 step, each against the others, within ``ROW_ULP``·|row| where the rows are
   bf16 (one rounding of f32 sums taken in different orders) plus ``TERMS`` of the
   element's summed update magnitudes (:func:`update_terms`: where two f32 sums round
   to neighbouring bf16 values of f_neg, a coefficient moves by 2^-8·|f_neg| relative,
   and |f_neg| < 8 at these parameters). This catches a wrong update, but not a kernel
   that computes in f32 and skips the bf16 roundings: bf16 and f32 compute differ by
   about one bf16 ulp an element, well inside it.
2. The update rows themselves, kernel against plain, in the compute dtype: d_in, d_pos
   and dZ as the kernel hands them back before its scatters where the parameters are
   bf16, the touched rows' deltas where they are f32. Both sides round the same f32
   values at the same places, so an element differs only where two sums taken in
   different orders fall on either side of a bf16 rounding boundary, which is rare.
   At most ``DIFFER_SHARE`` of the compared elements may differ at all, and at most
   ``BEYOND_SHARE`` by more than one bf16 ulp of the plain value (for a delta: the
   ulps of its updates summed, beyond the f32 additions' rounding). A max over the
   elements could not tell the forms apart, since one ulp is also what one rounding
   moves; the share of elements that move can. The same call with the bf16 compute
   and logits flags cleared (the f32 kernel; on bf16 parameters it still stores bf16
   rows) is the control: it must break this limit, or the check fails as unable to
   tell a bf16 kernel from an f32 one.
"""

from __future__ import annotations

from typing import Tuple

import torch

from glint_word2vec_torch.ops import scatter as scat
from glint_word2vec_torch.ops.fused_sgns import (
    alpha_on_card, fused_sgns_shared_kernel, fused_sgns_shared_step)
from glint_word2vec_torch.ops.sgns import (
    EmbeddingPair, _shared_pool_updates, sgns_step_shared_core, shared_pool_coeffs)

# name -> (param dtype, compute dtype, logits dtype, fused_logits, bf16_chain)
FORMS = {
    "trio": ("bfloat16", "bfloat16", "bfloat16", False, False),
    "trio_fused_chain": ("bfloat16", "bfloat16", "bfloat16", True, True),
    "f32_params_bf16_compute": ("float32", "bfloat16", "float32", False, False),
}
TERMS = 2.0 ** -4
ROW_ULP = 2.0 ** -7
DIFFER_SHARE = 0.02
BEYOND_SHARE = 0.002
LOSS_RTOL = 1e-2
_F32_ADD = 2.0 ** -23  # two f32 additions' rounding, one on each side, per update


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each element of ``x`` (float64; 0 at 0):
    2^(e - 8) for |x| in [2^(e-1), 2^e)."""
    x = x.double()
    _, e = torch.frexp(x)
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x), e - 8),
                       torch.zeros_like(x))


def update_agreement(kernel: torch.Tensor, plain: torch.Tensor, unit: torch.Tensor,
                     slack=0.0) -> dict:
    """Limit 2 on one set of compared elements (those nonzero on either side):
    ``differ_share``, the share where |kernel - plain| > ``slack``; ``beyond_share``,
    where it exceeds ``slack + unit``; ``max_ulps``, the largest |kernel - plain| /
    ``unit`` where ``unit`` > 0."""
    k, p = kernel.double(), plain.double()
    nz = (k != 0) | (p != 0)
    diff = (k - p).abs()
    n = max(int(nz.sum()), 1)
    pos = nz & (unit > 0)
    return {"compared": int(nz.sum()),
            "differ_share": int(((diff > slack) & nz).sum()) / n,
            "beyond_share": int(((diff > slack + unit) & nz).sum()) / n,
            "max_ulps": float((diff[pos] / unit[pos]).max()) if bool(pos.any()) else 0.0}


def passes(agreement: dict) -> bool:
    return (agreement["differ_share"] <= DIFFER_SHARE
            and agreement["beyond_share"] <= BEYOND_SHARE)


def update_terms(syn0, syn1, c, x, mask, neg, rows0, rows1, alpha: float,
                 num_negatives: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ|terms| of each touched element's update, in float64 on ``rows0``/``rows1``
    (the shared-pool step's products on absolute values)."""
    e_in, e_pos, Z = syn0[c].double(), syn1[x].double(), syn1[neg].double()
    *_, g_pos, g_neg = shared_pool_coeffs(e_in, e_pos, Z, x, neg, mask.double(), alpha,
                                          num_negatives, "exact")
    e_in, e_pos, Z, g_pos, g_neg = (t.abs() for t in (e_in, e_pos, Z, g_pos, g_neg))
    D, dev = syn0.shape[1], syn0.device
    t0 = torch.zeros((rows0.numel(), D), dtype=torch.float64, device=dev).index_add_(
        0, torch.searchsorted(rows0, c), g_pos[:, None] * e_pos + g_neg @ Z)
    t1 = torch.zeros((rows1.numel(), D), dtype=torch.float64, device=dev)
    t1.index_add_(0, torch.searchsorted(rows1, x), g_pos[:, None] * e_in)
    t1.index_add_(0, torch.searchsorted(rows1, neg), g_neg.T @ e_in)
    return t0, t1


def _row_sums(rows, idx_vals, D: int) -> torch.Tensor:
    """Σ over (idx, values) pairs of ``values`` into a float64 [len(rows), D] buffer."""
    out = torch.zeros((rows.numel(), D), dtype=torch.float64, device=rows.device)
    for idx, vals in idx_vals:
        out.index_add_(0, torch.searchsorted(rows, idx), vals.double())
    return out


def updates_against_plain(p0, p1, c, x, mask, neg, alpha: float, num_negatives: int,
                          plain_kw: dict, kernel_kw: dict) -> dict:
    """Limit 2: the kernel launched with ``kernel_kw`` against the plain step's update
    rows with ``plain_kw`` (both the step's dtype keywords)."""
    d_in, d_pos, d_Z, _ = _shared_pool_updates(
        p0, p1, c, x, mask, neg, alpha, num_negatives, "exact", torch.matmul, False,
        None, plain_kw["compute_dtype"], plain_kw["logits_dtype"], plain_kw["fused"],
        plain_kw["bf16_chain"])
    live = mask > 0
    pair = EmbeddingPair
    alpha_t = alpha_on_card(alpha, p0.device)  # the trainer's form; plain: the float
    if p0.dtype == torch.bfloat16:
        _, u0, u1 = fused_sgns_shared_kernel(pair(p0, p1), c, x, mask, neg, alpha_t,
                                             num_negatives, "exact", **kernel_kw)
        B = c.shape[0]
        kernel = torch.cat([u0[live], u1[:B][live], u1[B:]])
        plain = torch.cat([d_in[live], d_pos[live], d_Z]).to(torch.bfloat16)
        return update_agreement(kernel, plain, bf16_ulp(plain))
    g0, g1 = p0.clone(), p1.clone()
    fused_sgns_shared_kernel(pair(g0, g1), c, x, mask, neg, alpha_t, num_negatives,
                             "exact", **kernel_kw)
    w0 = p0.clone().index_add_(0, c, d_in.to(p0.dtype))
    w1 = p1.clone().index_add_(0, x, d_pos.to(p1.dtype)).index_add_(0, neg,
                                                                     d_Z.to(p1.dtype))
    rows0, rows1 = torch.unique(c[live]), torch.unique(torch.cat([x[live], neg]))
    D = p0.shape[1]
    parts = (((c[live], d_in[live]),), ((x[live], d_pos[live]), (neg, d_Z)))

    def per_row(fn):  # Σ fn(update) over each touched row's updates, syn0's then syn1's
        return torch.cat([_row_sums(rows, [(i, fn(v)) for i, v in ps], D)
                          for rows, ps in zip((rows0, rows1), parts)])

    unit = per_row(bf16_ulp)
    count = per_row(lambda v: torch.ones_like(v, dtype=torch.float64))
    size = torch.cat([p0[rows0], p1[rows1]]).double().abs() + per_row(torch.abs)
    kernel = torch.cat([(g0[rows0].double() - p0[rows0].double()),
                        (g1[rows1].double() - p1[rows1].double())])
    plain = torch.cat([(w0[rows0].double() - p0[rows0].double()),
                       (w1[rows1].double() - p1[rows1].double())])
    return update_agreement(kernel, plain, unit, _F32_ADD * count * size)


def check_form(base0, base1, c, x, mask, neg, form: str, alpha: float = 0.025,
               num_negatives: int = 5) -> dict:
    """The fused step's bf16 form ``form`` (a key of :data:`FORMS`) on ``base0``/
    ``base1`` cast to its parameter dtype, held to both limits. Returns the readings
    and ``failures``, the names of the limits it broke (empty when it passes)."""
    pd, cd, ld, fz, ch = FORMS[form]
    pd, cd, ld = (getattr(torch, t) for t in (pd, cd, ld))
    kw = dict(compute_dtype=cd, logits_dtype=ld, fused=fz, bf16_chain=ch)
    control_kw = dict(compute_dtype=torch.float32, logits_dtype=torch.float32, fused=fz,
                      bf16_chain=False)
    pair = EmbeddingPair
    p0, p1 = base0.to(pd), base1.to(pd)
    rows0 = torch.unique(c)
    rows1 = torch.unique(torch.cat([x, neg]))
    want, wm = sgns_step_shared_core(pair(p0, p1), c, x, mask, neg, alpha, num_negatives,
                                     "exact", **kw)
    ref, _ = sgns_step_shared_core(pair(p0.double(), p1.double()), c, x, mask.double(),
                                   neg, alpha, num_negatives, "exact")
    terms = update_terms(p0, p1, c, x, mask, neg, rows0, rows1, alpha, num_negatives)
    g0, g1 = p0.clone(), p1.clone()
    before = (fused_sgns_shared_step.launches, scat.scatter_add_rows_.launches)
    gm = fused_sgns_shared_step(pair(g0, g1), c, x, mask, neg,
                                alpha_on_card(alpha, p0.device), num_negatives, "exact",
                                **kw)
    scat.check_errors()
    torch.cuda.synchronize()
    launches = (fused_sgns_shared_step.launches - before[0],
                scat.scatter_add_rows_.launches - before[1])
    store = pd == torch.bfloat16
    errs, shares = {}, {}
    for k, p_, r, t, rows in ((g0, want.syn0, ref.syn0, terms[0], rows0),
                              (g1, want.syn1, ref.syn1, terms[1], rows1)):
        k, p_, r = k[rows].double(), p_[rows].double(), r[rows]
        tol = TERMS * t + (ROW_ULP * r.abs() if store else 0.0) + 1e-6
        for key, a, b in (("kernel_plain", k, p_), ("kernel_f64", k, r),
                          ("plain_f64", p_, r)):
            errs[key] = max(errs.get(key, 0.0), float((a - b).abs().max()))
            shares[key] = max(shares.get(key, 0.0), float(((a - b).abs() / tol).max()))
    moved = float((g0[rows0].double() - p0[rows0].double()).abs().max())
    loss_rel = abs(float(gm.loss) - float(wm.loss)) / abs(float(wm.loss))
    pairs_equal = float(gm.pairs) == float(wm.pairs)
    del want, ref, terms, g0, g1
    updates = updates_against_plain(p0, p1, c, x, mask, neg, alpha, num_negatives, kw, kw)
    control = updates_against_plain(p0, p1, c, x, mask, neg, alpha, num_negatives, kw,
                                    control_kw)
    scat.check_errors()
    failures = [name for name, ok in (
        ("rows", max(shares.values()) <= 1.0), ("updates", passes(updates)),
        ("control passes the update limit", not passes(control)),
        ("loss", loss_rel <= LOSS_RTOL), ("pairs", pairs_equal),
        ("moved", moved > 1e-3), ("finite", torch.isfinite(gm.loss).item()),
        ("launches", launches == (1, 2 * store))) if not ok]
    return {"max_abs_err": errs["kernel_plain"], "max_abs_err_f64": errs["kernel_f64"],
            "errs": errs, "bound_share": shares, "updates": updates,
            "control": control, "loss_rel_err": loss_rel, "moved": moved,
            "failures": failures}
