"""The numbers a training cell compares with its reference.

Each is a worst case over the steps or the leaves. A leaf's reading is
the gap between the program's norm and the reference's, not the norm
of their difference, over the reference's norm of that leaf or of the
median leaf, whichever is larger (some gradients are all but zero).
"""

from __future__ import annotations

import statistics

import torch

# A leaf whose first reference gradient is under this share of the
# median leaf's moves by round-off alone (a conv feeding a BatchNorm
# whose scale starts at zero): its change is not compared.
STILL = 1e-3


def norms(leaves: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def worst_gap(program: dict, reference: dict,
              keep=None) -> tuple[float, str]:
    """(the largest leaf gap, its leaf) over the leaves in ``keep``
    (all by default)."""
    floor = statistics.median(reference.values())
    worst = (0.0, "")
    for leaf, ref in reference.items():
        if keep is not None and leaf not in keep:
            continue
        gap = abs(program[leaf] - ref) / max(ref, floor, 1e-30)
        worst = max(worst, (gap, leaf))
    return worst


def moved(first_grad: dict) -> set[str]:
    """The leaves whose first reference gradient is not nought to
    rounding (:data:`STILL`)."""
    floor = STILL * statistics.median(first_grad.values())
    return {k for k, v in first_grad.items() if v >= floor}


def loss_gap(program: list, reference: list) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def training_checks(limits: dict, losses, ref_losses, grad, ref_grad,
                    change, ref_change) -> tuple[list, dict]:
    """(checks, notes): ``loss`` over the compared steps, ``grad`` (the
    first gradient) and ``change`` (the parameters' change over the
    compared steps, leaves that move only) by the worst leaf."""
    g, g_leaf = worst_gap(grad, ref_grad)
    c, c_leaf = worst_gap(change, ref_change, keep=moved(ref_grad))
    checks = [("loss", loss_gap(losses, ref_losses), limits["loss"]),
              ("grad", g, limits["grad"]), ("change", c, limits["change"])]
    notes = {"losses": losses, "ref_losses": ref_losses,
             "grad_leaf": g_leaf, "change_leaf": c_leaf,
             "still_leaves": len(ref_grad) - len(moved(ref_grad))}
    return checks, notes
