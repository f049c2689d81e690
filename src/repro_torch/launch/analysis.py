"""Roofline terms from the cost model: the port of
``repro/launch/analysis.py``.

    compute    = dot_FLOPs / (chips * peak_FLOPs)
    memory     = HBM_bytes / (chips * HBM_bw)
    collective = link_bytes / (chips * link_bw)

FLOPs, bytes and collective link bytes come from the op-level cost model in
:mod:`repro_torch.launch.graph_analysis` (``analyze``), over one recorded
run of the step; the port's layer loop runs eagerly, so no loop correction
is needed (the reference corrects XLA's ``cost_analysis``, which counts a
``while`` body once).
"""
from __future__ import annotations

# ---- NVIDIA H100 80GB HBM3 (SXM) constants, per card ----
# NVIDIA's H100 data sheet, dense rates at the full 700 W power limit:
# bf16 tensor-core peak and HBM3 bandwidth (the rates chip_smoke.py's
# bounds use); NVLink 4's 900 GB/s a card, 450e9 bytes/s a direction, in
# place of the reference's ICI link; the card's 80 GB of HBM.
PEAK_FLOPS = 989e12          # bf16 dense
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s, NVLink 4, one direction
HBM_PER_CHIP = 80e9          # bytes


def roofline(flops: float, hbm_bytes: float, coll_bytes: float,
             chips: int) -> dict:
    """All inputs are per-chip quantities when chips == 1."""
    terms = {
        "compute_s": flops / (chips * PEAK_FLOPS),
        "memory_s": hbm_bytes / (chips * HBM_BW),
        "collective_s": coll_bytes / (chips * LINK_BW),
    }
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    terms["bound_s"] = terms[dom]
    total = sum(v for k, v in terms.items() if isinstance(v, float)
                and k.endswith("_s") and k != "bound_s")
    terms["balance_fraction"] = terms["bound_s"] / total if total else 0.0
    return terms


def model_flops(n_params_active: int, tokens: int, mode: str) -> float:
    """6*N*D for train (fwd+bwd), 2*N*D for a forward pass."""
    mult = 6.0 if mode == "train" else 2.0
    return mult * n_params_active * tokens
