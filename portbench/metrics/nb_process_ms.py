"""nb_process_ms: host ms between successive block starts of
Sniffer.run (the harness's control stamps) over the intervals in which
the next input was already waiting, outside the traced span."""


def read(rec):
    total, n = rec.spans.get("process", (0.0, 0))
    return total / n * 1e3 if n else None
