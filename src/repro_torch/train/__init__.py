from repro_torch.train.serve import SpmvRequest, SpmvServer

__all__ = ["SpmvRequest", "SpmvServer"]
