"""Host milliseconds per call, from the benchmark's own span around each
call into the program's entry points, before any synchronize that closes
the call: the enqueue time, plus any wait inside the call where the
program synchronises, and where the mix keeps calls in flight, the wait
in CUDA's full launch queue (then the card's pace, once the host is
ahead)."""


def read(run):
    if not run.host_ms:
        return None
    return sum(run.host_ms) / len(run.host_ms)
