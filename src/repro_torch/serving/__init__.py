from repro_torch.serving.scheduler import BatchedServer, Request

__all__ = ["BatchedServer", "Request"]
