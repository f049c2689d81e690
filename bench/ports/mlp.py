"""The port's task for FedAvg's 2NN (``bench/models/mlp.py``)."""


def port_task(cfg: dict):
    """``data/synthetic.py::mlp_task`` at the configuration's sizes."""
    from repro_torch.data.synthetic import mlp_task
    return mlp_task(hidden=cfg["hidden"], image_size=cfg["image_size"],
                    channels=cfg["channels"], num_classes=cfg["num_classes"])
