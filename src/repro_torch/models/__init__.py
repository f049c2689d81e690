from repro_torch.models import cnn, modules

__all__ = ["cnn", "modules"]
