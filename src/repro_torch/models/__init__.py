from repro_torch.models.transformer import Model, build_model
from repro_torch.models import attention, cnn, modules

__all__ = ["Model", "build_model", "attention", "cnn", "modules"]
