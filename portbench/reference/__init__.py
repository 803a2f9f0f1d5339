"""The benchmark's plain reference of the LoRa PHY (``phy``: parameters,
modulator, codecs; ``rx``: receivers).  It imports torch alone: nothing of
the program under test and nothing of the JAX package."""
