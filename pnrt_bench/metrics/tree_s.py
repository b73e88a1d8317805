"""tree_s: host seconds of the program's ``build.tree`` spans (the BVH
build inside ``SceneBuilder.build``: the native SAH builder), from the
program's record.  Part of ``build_s``.  Moves ``setup_s``."""

from pnrt_bench import replays


def read(run):
    rec = replays.program_record()
    span = rec["spans"].get("build.tree") if rec else None
    return span["seconds"] if span else None
