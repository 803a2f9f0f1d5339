from . import modem, tones
