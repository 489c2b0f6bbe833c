"""Runnable narratives of the port, one per surface of the system:

    python -m repro_torch.examples.quickstart        # the staged frontend
    python -m repro_torch.examples.serve_mixed       # MixedServer over a model forward
    python -m repro_torch.examples.decode_stream     # continuous batching
    python -m repro_torch.examples.offload_library   # library-scope offloading
    python -m repro_torch.examples.train_lm          # training, checkpoints, resume

Each runs its units, schedulers and models on the CUDA card; ``--device
cpu`` runs them on the CPU, and without a card and without it each raises.
"""
