from repro_torch.train.serve import BatchedServer, ServeConfig, SpmvRequest, SpmvServer

__all__ = ["BatchedServer", "ServeConfig", "SpmvRequest", "SpmvServer"]
