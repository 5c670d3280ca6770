"""Padding rows over all rows of every decode batch the window launched
(BatchedChunkDecoder pads each batch to max_batch rows), in %."""


def read(t):
    rows = t.get("rows")
    if not rows:
        return None
    return 100.0 * sum(b - r for r, b in rows) / sum(b for _, b in rows)
