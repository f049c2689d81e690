from repro_torch.metaheuristics.base import Metaheuristic, best_member
from repro_torch.metaheuristics.bwo import bwo

# The other FedX meta-heuristics (pso, gwo, sca, avo) are still to be
# ported (ROADMAP.md, queue 1, item 7).
REGISTRY = {"bwo": bwo}

__all__ = ["Metaheuristic", "best_member", "bwo", "REGISTRY"]
