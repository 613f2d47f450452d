"""Entry point: ``python -m mpi_pytorch_tpu_torch.train [--flags]`` —
``parse_config`` then ``train`` on the card (``MPT_PLATFORM=cpu`` for the
CPU)."""

from mpi_pytorch_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
