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
rotate-detect route).  The SX1272 framed codec (``models/frame.py``:
explicit header, whitening, FEC at the profile's coding rate, the diagonal
interleave, Gray) rides the same kernels, its padded decoder one kernel of
its own on the card, and ``receive_stream_frames``
receives streams of frames of mixed lengths.  ``ops/channel.py`` and
``models/sweep.py`` give the AWGN BER/PER sweep, ``models/lorawan.py`` the
LoRaWAN MAC (host AES/CMAC through ``utils/native.py``), and ``runners/``
the command-line tools, the golden-vector dumper ``vector_dump`` among them
(``--device cpu`` for the CPU).  The parallel layer runs on
``torch.distributed``, one rank per device: ``parallel/mesh.py`` and
``parallel/distributed.py`` build the ('dp', 'sp') and ('host', 'dp',
'sp') meshes of ranks and place batches on them as DTensors (channel data
parallelism with no collectives), and ``stream_scan``, ``receive_stream``
and ``receive_stream_frames`` take a ``mesh``/``axis`` that shards a
stream's time axis over ``sp`` with halos of the next ranks' samples.
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
from .models import lorawan, sweep
from .models.frame import (
    encode_frame, decode_frame, decode_frame_padded, decode_header,
    frame_symbols, max_frame_symbols, FrameHeader, FrameResult,
)
from .ops import channel
from .parallel import mesh, streaming
from .parallel.receiver import (
    receive_stream, receive_stream_frames, stream_rx_init,
    stream_frames_init, packet_samples, StreamRxState,
    RecoveredPackets, RecoveredFrames,
)

__version__ = "0.1.0"
