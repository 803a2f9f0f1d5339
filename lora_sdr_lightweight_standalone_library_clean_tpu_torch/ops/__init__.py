from . import codes, chirp, dft, detect
