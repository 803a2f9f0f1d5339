"""LoRa PHY on PyTorch and CUDA: the port of the TPU-native JAX package.

A PyTorch re-implementation of ``lora_sdr_lightweight_standalone_library_
clean_tpu`` for one NVIDIA H100, kept beside it with the same layout
(``utils/``, ``ops/``, ``models/``) and function names.  It imports torch
and numpy and never jax.  The entry points run on the card unless the
caller asks for the CPU: host data (numpy arrays, lists) and
``from_complex`` go to the CUDA card, and raise without one; CPU tensors,
or ``device="cpu"``, run plain PyTorch.  CUDA tensors run the hand-written
Hopper kernels in ``csrc/`` (built by ``utils/cuda_build.py`` at first
use) wherever the JAX package runs a Pallas kernel on the TPU.

It covers sf2 to sf12 on the card: the packet pipeline ``encode ->
modulate_dechirped -> demodulate_tones -> decode`` and the full-RX entry
point ``modulate -> demodulate`` (with ``estimate_offsets`` and
``compensate_offsets``) at any osr, and the injective wide receiver
``demodulate_wide`` for BW250/500 at osr >= bw_scale.  The streaming
receiver ``receive_stream`` (``parallel/``) takes chunks of a continuous
stream and returns the packets in it, and ``demodulate_tones``/``demodulate``
take the JAX package's ``backend`` values (``"pallas"`` is the two-stage
rotate-detect route).
"""
from .utils.config import (LoraParams, Window, load_profiles,
                           params_from_profile, params_from_reference,
                           STOCK_PROFILES)
from .utils import errors
from .models.modem import (
    encode, decode, modulate, modulate_dechirped, estimate_offsets,
    compensate_offsets, demodulate, demodulate_wide, dechirp, to_complex,
    from_complex, crc_sx1272, DemodResult, OffsetEstimate,
)
from .models.tones import demodulate_tones
from .parallel import streaming
from .parallel.receiver import (
    receive_stream, stream_rx_init, packet_samples, StreamRxState,
    RecoveredPackets,
)

__version__ = "0.1.0"
