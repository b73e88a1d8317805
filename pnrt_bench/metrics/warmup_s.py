"""warmup_s: host seconds of the program's ``capture.warmup`` spans (the
eager warm-up frame a ``FrameProgram`` runs on a side stream before it
captures), from the program's record.  Moves ``setup_s``."""

from pnrt_bench import replays


def read(run):
    rec = replays.program_record()
    span = rec["spans"].get("capture.warmup") if rec else None
    return span["seconds"] if span else None
