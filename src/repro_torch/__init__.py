"""``repro_torch`` — the PyTorch/CUDA port of the mixed-execution system.

Module for module it mirrors the JAX package ``repro`` (the reference it is
tested against): the numpy guest emulator is shared by construction, the
host side runs eager torch on a :class:`torch.device` (CUDA unless the
caller asks for the CPU), and the paged decode attention runs a CUDA kernel
written for Hopper (``csrc/paged_decode_attention.cu``).

    from repro_torch import mixed
    hybrid = mixed.trace(program).plan("tech-gfp").compile()   # on the card
    out = hybrid(*args)
"""
