"""The comparison that decides ``correct``: what the timed path produced,
at the timed sizes, against the configuration's plain reference.

Serving: for each sampled request, the reference runs once over the
prompt and its served tokens; at each served position the gap is how
far the served token's logit lies below the reference's best there.
The number compared is the widest gap, ``widest_logit_gap``.  The
control (``control=True``) puts the reference at fp8 in the program's
place: at the same positions, the gap of the token that the fp8 forward
puts first is what is held to the limit, and decides ``correct``.

Training: the program's first three steps (losses, the first clipped
gradient as AdamW's ``m`` holds it, each leaf's change after three
steps) against the reference's three steps from the same weights on the
same batches.  Leaf by leaf, the gap between the two norms over the
reference's norm of that leaf or of the median leaf, whichever is
larger; leaves whose reference gradient is under a thousandth of the
median leaf's are left out of the change (they move by round-off).
Numbers: ``loss_gap`` (the worst step's |Δloss| / loss),
``grad_norm_gap`` and ``delta_norm_gap`` (the worst leaf's).  The
control runs the reference's three steps at fp8 in the program's place.

Each number is held to its limit in ``limits/<workload>.json``; a
number without a limit, or not finite, is not correct.
"""
from __future__ import annotations

import math
import statistics

import torch


def within(checks: dict) -> bool:
    """Every number finite and at or under its limit."""
    return bool(checks) and all(
        lim is not None and math.isfinite(v) and v <= lim
        for v, lim in checks.values())


def hold(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit (None where the limits file has
    none)."""
    return {name: (value, limits.get(name, {}).get("limit"))
            for name, value in numbers.items()}


def served(ref, c: dict, params: dict, seqs: list, limits: dict, *,
           control: bool = False):
    """(checks, readings) of served requests ``seqs``: (prompt ids,
    served tokens) pairs.  With ``control`` the fp8 control's widest gap
    is held in the program's place, and the program's is a reading."""
    dev = params["embed"].device
    widest, widest_ctrl, n = -math.inf, -math.inf, 0
    for prompt, served_toks in seqs:
        ids = torch.as_tensor(list(prompt) + served_toks[:-1],
                              dtype=torch.long, device=dev)
        L = len(prompt)
        lg = ref.logits(c, params, ids)[L - 1:]
        tok = torch.as_tensor(served_toks, dtype=torch.long, device=dev)
        best = lg.max(dim=-1).values
        gaps = best - lg.gather(1, tok[:, None])[:, 0]
        widest = max(widest, float(gaps.max()))
        n += len(served_toks)
        if control:
            lc = ref.logits(c, params, ids, mode="fp8")[L - 1:]
            pick = lc.argmax(dim=-1)
            g = best - lg.gather(1, pick[:, None])[:, 0]
            widest_ctrl = max(widest_ctrl, float(g.max()))
        del lg
    if not seqs:
        widest = widest_ctrl = math.inf
    readings = {"served_tokens_compared": n, "requests_compared": len(seqs)}
    if control:
        readings["program_widest_logit_gap"] = widest
        widest = widest_ctrl
    return hold({"widest_logit_gap": widest}, limits), readings


def norm_gaps(program: list, reference: list, ref_grads: list) -> list:
    """Each leaf's |‖program‖ − ‖reference‖| over max(‖reference leaf‖,
    the median leaf's), leaving out leaves whose reference gradient is
    under a thousandth of the median leaf's."""
    med_g = statistics.median(ref_grads)
    med = statistics.median(reference)
    return [abs(p - r) / max(r, med)
            for p, r, g in zip(program, reference, ref_grads)
            if g >= 1e-3 * med_g]


def trained(prog: dict, refr: dict) -> dict:
    """The training numbers of program readings ``prog`` against the
    reference's ``refr``: each a dict of ``losses``, ``grad_norms`` and
    ``delta_norms`` (leaf order of the reference's ``leaf_specs``)."""
    g = refr["grad_norms"]
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in
                            zip(prog["losses"], refr["losses"])),
            "grad_norm_gap": max(norm_gaps(prog["grad_norms"], g, g)),
            "delta_norm_gap": max(norm_gaps(prog["delta_norms"],
                                            refr["delta_norms"], g))}
