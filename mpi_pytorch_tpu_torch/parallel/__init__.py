"""Data parallelism over ``torch.distributed`` (``mpi_pytorch_tpu/parallel``):
the process world (``distributed``), its collectives (``collectives``) and
a local launcher of N ranks (``launch``)."""
