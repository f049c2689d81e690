from repro_torch.data.synthetic import (make_cifar_like, make_token_dataset,
                                        cnn_task, mlp_task)
from repro_torch.data.partition import partition_iid, partition_dirichlet
from repro_torch.data.loader import batch_dataset, client_batches

__all__ = ["make_cifar_like", "make_token_dataset", "cnn_task", "mlp_task", "partition_iid",
           "partition_dirichlet", "batch_dataset", "client_batches"]
