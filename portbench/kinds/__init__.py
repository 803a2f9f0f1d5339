"""The kinds of traffic, one module each, found by the ``kind`` of a mix
(``spec.kind``).  A module ``<kind>.py`` holds:

- ``NUMBERS``: the names of the numbers its comparison gives, each with a
  limit in ``portbench/limits/<cell>.json``; ``FAILED``: those that count
  packets not delivered as the comparison requires;
- ``build(mix, phy, g, dev)``: one input (``generate.Input``) made with
  the generator ``g`` on ``dev``;
- ``shapes(mix, phy)``: the sizes of one call that the per-layer readers
  count (``samples``, the air a call receives, among them);
- ``entry(lora, params, mix, phy)``: the program's call on one input, as
  a function of the input;
- ``outputs(out)``: a call's outputs as the dict ``compare`` reads;
- ``reference(mix, phy, inp, prec)``: the plain reference's outputs on the
  same input, in ``"f64"`` or a step below it (``"tf32"``, the control);
- ``compare(got, ref, truth, mix, phy)``: the numbers of one call.

A new kind is a new module here; nothing else is edited.

A kind for a cell of ``chips`` > 1 has the same interface.  Each rank
runs it on its own card (``ranks.py``) after the program's process group
exists, so ``entry`` builds its mesh with the port's ``global_mesh`` (and
shards each input with the port's shardings); ``build`` makes the same
full input on every rank.  ``compare`` judges one rank's outputs: the run
takes each number's widest reading over the ranks.  ``shapes`` sizes the
whole call, as the end-to-end rates read it; the accepted roofline readers
set those sizes against rank 0's trace alone, so a sharded cell reports
rooflines through readers of its own that count one rank's share.
"""
