"""Every name both packages export has the JAX package's signature in the
port, up to the deliberate differences listed here by name.

A name is exported when it is public in the package's namespace (the
subpackages themselves aside) or in the ``__all__`` of an exported module
(``errors``, ``mesh``, ``streaming``, ``channel``, ``sweep``,
``lorawan``).  Two
signatures agree when their parameters have the same names, kinds and
defaults, in order; annotations differ by design (``jnp.ndarray`` against
``torch.Tensor``) and are not compared.  The deliberate differences:

- ``device=`` arguments: host data (and a mesh's ranks) go to the CUDA
  card unless the caller names another device;
- a ``torch.Generator`` (``generator``) where JAX takes a PRNG ``key``;
- the JAX-only name ``streaming.race_stream_backends`` (the TPU's
  stream-scan crossover race, not carried over);
- no ``"jnp"`` route: ``backend`` keeps its JAX default and values, and a
  CPU tensor is the plain route, so ``"jnp"`` raises (checked below).
"""
import enum
import inspect
import types

import pytest

import jax

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu as J  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean_tpu_torch as T  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean_tpu_torch.utils.errors import (  # noqa: E402
    InvalidArgumentError)

torch.set_num_threads(1)

SUBPACKAGES = {"models", "ops", "parallel", "utils", "runners"}
DEVICE = {"from_complex", "stream_rx_init", "stream_frames_init",
          "lorawan.build_frame", "sweep.per_sweep", "mesh.make_mesh"}
GENERATOR = {"channel.awgn", "channel.apply_channel"}
JAX_ONLY = {"streaming.race_stream_backends"}


def _public(pkg):
    return {n for n in dir(pkg) if not n.startswith("_")} - SUBPACKAGES


def _exports(pkg):
    """{dotted name: object} of the package's exports."""
    out = {}
    for name in _public(pkg):
        obj = getattr(pkg, name)
        if isinstance(obj, types.ModuleType):
            for sub in getattr(obj, "__all__", ()):
                out[f"{name}.{sub}"] = getattr(obj, sub)
        else:
            out[name] = obj
    return out


J_EXPORTS, T_EXPORTS = _exports(J), _exports(T)
SHARED = sorted(n for n in set(J_EXPORTS) & set(T_EXPORTS)
                if callable(J_EXPORTS[n]))


def _default(value):
    """Defaults compare by value; an enum member by its class name and
    value (each package has its own ``Window``)."""
    if isinstance(value, enum.Enum):
        return type(value).__name__, value.value
    return value


def _normalised(name, jax_fn, port_fn, used):
    """The two parameter lists as (name, kind, default), with the
    deliberate differences taken out; records in ``used`` which rule
    applied to ``name``."""
    jsig = inspect.signature(jax_fn).parameters.values()
    tsig = inspect.signature(port_fn).parameters.values()
    want = [(p.name, p.kind, _default(p.default)) for p in jsig]
    got = []
    for p in tsig:
        if p.name == "device":
            used.setdefault("device", set()).add(name)
            continue
        pname = p.name
        if pname == "generator":
            used.setdefault("generator", set()).add(name)
            pname = "key"
        got.append((pname, p.kind, _default(p.default)))
    return want, got


@pytest.mark.parametrize("name", SHARED)
def test_signature_matches_jax(name):
    want, got = _normalised(name, J_EXPORTS[name], T_EXPORTS[name], {})
    assert got == want, name


def test_deliberate_differences_are_exactly_the_listed_ones():
    used = {}
    for name in SHARED:
        _normalised(name, J_EXPORTS[name], T_EXPORTS[name], used)
    assert used == {"device": DEVICE, "generator": GENERATOR}
    assert set(J_EXPORTS) - set(T_EXPORTS) == JAX_ONLY
    assert set(T_EXPORTS) - set(J_EXPORTS) == {"params_from_reference"}


def test_no_jnp_route_and_keyword_only_stride():
    p = T.LoraParams(sf=9, bw=250000, osr=2)
    z = torch.zeros(1, 4 * p.step)
    for fn in (T.demodulate_tones, T.demodulate, T.demodulate_wide):
        with pytest.raises(InvalidArgumentError, match="jnp"):
            fn(z, z, p, backend="jnp")
    T.demodulate_wide(z, z, p, backend="pallas_rx")
    s = torch.zeros(4 * p.step)
    with pytest.raises(InvalidArgumentError, match="jnp"):
        T.streaming.stream_scan(s, s, p, backend="jnp")
    with pytest.raises(TypeError, match="DeviceMesh"):
        T.streaming.stream_scan(s, s, p, p.step)      # the 4th is the mesh
    assert T.streaming.stream_scan(s, s, p, stride=p.step,
                                   backend="pallas").index.shape == (4,)
