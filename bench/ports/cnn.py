"""The port's task for the paper CNN (``bench/models/cnn.py``)."""
import dataclasses


def port_task(cfg: dict):
    """``data/synthetic.py::cnn_task`` at the configuration's sizes."""
    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.data.synthetic import cnn_task
    fields = {f.name for f in dataclasses.fields(CNNConfig)} - {"name"}
    return cnn_task(CNNConfig(**{k: cfg[k] for k in fields}))
