"""Run telemetry of the trainer (``mpi_pytorch_tpu/obs/``): per-step
health records and the non-finite sentinel (``health``), the ranks' step
time heartbeat with straggler flagging (``heartbeat``)."""
