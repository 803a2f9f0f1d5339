from . import config, errors
