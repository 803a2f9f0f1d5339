"""Valid candidate rows a stream call returns over the packets planted in
its input: the streaming receiver's rows of work per packet.  Sync matches
inside frames count, so above 1 it is the layer's wasted work.  Read from
the program's outputs of the compared calls."""


def read(run):
    rows = [int(out["start"].numel()) for out in run.outputs
            if "start" in out]
    if not rows or not run.planted:
        return None
    return sum(rows) / len(rows) / run.planted
