from repro_torch.metaheuristics.base import Metaheuristic, best_member
from repro_torch.metaheuristics.avo import avo
from repro_torch.metaheuristics.bwo import bwo
from repro_torch.metaheuristics.pso import pso
from repro_torch.metaheuristics.gwo import gwo
from repro_torch.metaheuristics.sca import sca

REGISTRY = {"bwo": bwo, "pso": pso, "gwo": gwo, "sca": sca, "avo": avo}

__all__ = ["Metaheuristic", "best_member", "avo", "bwo", "pso", "gwo",
           "sca", "REGISTRY"]
