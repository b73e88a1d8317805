"""walk_pops.bvh: node pops per live query of the plain-BVH walks,
closest and shadow queries together, over the bounces and tiles of the
warm-up frame of the program's last capture that counted any (the
``walk.closest.pops`` / ``walk.shadow.pops`` over ``walk.closest.queries``
/ ``walk.shadow.queries`` counters, route ``bvh`` only), read from the
program's record whatever the traced stretch holds.  A better tree or a
wider node lowers it; a ray order that only improves coherence lowers
``walk_ms.bvh`` and leaves it.  Moves ``frame_ms.large``; silent where
the program counts no walk."""

from pnrt_bench import replays

KINDS = ("closest", "shadow")


def read(run):
    rec = replays.program_record()
    for cap in reversed(rec["captures"] if rec else []):
        total = {"pops": 0.0, "queries": 0.0}
        for name, _, _, value in cap["counts"]:
            parts = name.split(".")
            if (len(parts) == 3 and parts[0] == "walk"
                    and parts[1] in KINDS and parts[2] in total):
                total[parts[2]] += value
        if total["queries"]:
            return total["pops"] / total["queries"]
    return None
