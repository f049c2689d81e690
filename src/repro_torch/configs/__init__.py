from repro_torch.configs.paper_cnn import CONFIG, CNNConfig

__all__ = ["CONFIG", "CNNConfig"]
