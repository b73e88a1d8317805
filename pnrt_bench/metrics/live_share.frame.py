"""live_share.frame: the live rays over the rays launched, summed over
the bounces and tiles of the warm-up frame of the captured frame the
stretch replays (the program's ``rays.live`` and ``rays.launched``
counters), in %: the share of the wavefront's ray-bounces that are not
masked lanes.  Moves ``frame_ms``."""

from pnrt_bench import replays


def read(run):
    found = replays.replays(run)
    if found is None:
        return None
    total = {"rays.live": 0.0, "rays.launched": 0.0}
    for name, _, _, value in found[0]["counts"]:
        if name in total:
            total[name] += value
    if not total["rays.launched"]:
        return None
    return 100.0 * total["rays.live"] / total["rays.launched"]
