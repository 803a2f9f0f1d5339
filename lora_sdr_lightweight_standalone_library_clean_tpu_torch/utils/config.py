"""Configuration dataclasses shared by the library and its tests.

PyTorch port of ``lora_sdr_lightweight_standalone_library_clean_tpu/utils/
config.py``: the same frozen, hashable ``LoraParams`` (the reference's
``lora_params`` struct, include/lora_phy/phy.hpp:53-60), the same profile
parser and the same stock profiles.  The slice has no learned state; its
state is these params plus the numpy constant tables the ops build from them,
so ``params_from_reference`` is what carries state across from another
implementation.
"""
from __future__ import annotations

import dataclasses
import enum
from pathlib import Path


class Window(enum.Enum):
    NONE = "none"
    HANN = "hann"


BANDWIDTHS = (125000, 250000, 500000)


@dataclasses.dataclass(frozen=True)
class LoraParams:
    """Static modem parameters (phy.hpp:53-60).

    ``bw`` is in Hz and must be one of 125/250/500 kHz; ``bw_scale`` mirrors
    phy.hpp:49-51.  Frozen + hashable so it can key the per-device constant
    table caches.
    """

    sf: int = 7
    bw: int = 125000
    cr: str = "4/5"
    osr: int = 1
    window: Window = Window.NONE
    sync_word: int = 0x12

    def __post_init__(self):
        if not (2 <= self.sf <= 12):
            raise ValueError(f"sf must be in [2,12], got {self.sf}")
        if self.bw not in BANDWIDTHS:
            raise ValueError(f"bw must be one of {BANDWIDTHS}, got {self.bw}")
        if self.osr < 1:
            raise ValueError(f"osr must be >= 1, got {self.osr}")
        if isinstance(self.window, str):
            object.__setattr__(self, "window", Window(self.window))

    @property
    def n(self) -> int:
        """Base samples per symbol, N = 2^sf."""
        return 1 << self.sf

    @property
    def step(self) -> int:
        """Oversampled samples per symbol."""
        return self.n * self.osr

    @property
    def bw_scale(self) -> int:
        """Integer bandwidth scale bw/125kHz (phy.hpp:49-51)."""
        return self.bw // 125000

    @property
    def rdd(self) -> int:
        """Redundancy bits from the coding-rate string 4/(4+rdd)."""
        num, _, den = self.cr.partition("/")
        if den:
            return int(den) - int(num)
        return int(num)  # already an index

    def sync_nibble_symbols(self) -> tuple[int, int]:
        """The two sync-word chirp symbol values (LoRaMod.cpp:20-22)."""
        shift = self.sf - 4 if self.sf > 4 else 0
        return ((self.sync_word >> 4) << shift) & 0xFFFF, (
            (self.sync_word & 0x0F) << shift
        ) & 0xFFFF


def params_from_reference(obj) -> LoraParams:
    """Build a ``LoraParams`` from any object with the fields
    ``sf, bw, cr, osr, window, sync_word`` (for example the JAX package's
    own ``LoraParams``).  ``window`` may be an enum member or its string
    value."""
    window = getattr(obj.window, "value", obj.window)
    return LoraParams(sf=int(obj.sf), bw=int(obj.bw), cr=str(obj.cr),
                      osr=int(obj.osr), window=Window(window),
                      sync_word=int(obj.sync_word))


def load_profiles(path: str | Path) -> list[dict]:
    """Parse the reference's ``tests/profiles.yaml`` subset format.

    Accepts the same flat ``- / key: value`` layout the reference tests parse
    by hand (tests/e2e_chain_test.cpp:25-52).
    """
    profiles: list[dict] = []
    current: dict | None = None
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("-"):
            if current:
                profiles.append(current)
            current = {}
            continue
        key, _, val = line.partition(":")
        if current is None or not _:
            continue
        key, val = key.strip(), val.strip()
        if key in ("sf", "bw"):
            current[key] = int(val)
        else:
            current[key] = val
    if current:
        profiles.append(current)
    return profiles


def params_from_profile(profile: dict, osr: int = 1,
                        window: Window = Window.NONE,
                        sync_word: int = 0x12) -> LoraParams:
    return LoraParams(sf=profile["sf"], bw=profile["bw"],
                      cr=profile.get("cr", "4/5"), osr=osr,
                      window=window, sync_word=sync_word)


# The shipped profiles file (same subset format as the reference's
# tests/profiles.yaml; see load_profiles above).
PROFILES_PATH = Path(__file__).resolve().parent.parent / "profiles.yaml"

# The seven stock profiles from the reference suite (tests/profiles.yaml:4-45).
# Kept as an in-code literal so importing the package does no file IO;
# tests assert load_profiles(PROFILES_PATH) stays in sync with this tuple.
STOCK_PROFILES = (
    {"name": "sf7_bw125_cr45", "sf": 7, "bw": 125000, "cr": "4/5"},
    {"name": "sf7_bw125_cr47", "sf": 7, "bw": 125000, "cr": "4/7"},
    {"name": "sf8_bw125_cr45", "sf": 8, "bw": 125000, "cr": "4/5"},
    {"name": "sf9_bw250_cr48", "sf": 9, "bw": 250000, "cr": "4/8"},
    {"name": "sf10_bw250_cr47", "sf": 10, "bw": 250000, "cr": "4/7"},
    {"name": "sf11_bw500_cr45", "sf": 11, "bw": 500000, "cr": "4/5"},
    {"name": "sf12_bw500_cr45", "sf": 12, "bw": 500000, "cr": "4/5"},
)
