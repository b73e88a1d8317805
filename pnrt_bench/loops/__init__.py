"""The loop of each traffic ``kind`` (``traffic/<mix>.json`` names it):
a module with ``Loop`` (set-up, the timed window, the profiled stretch,
the check) and ``control`` (the check's numbers with the reference in
bfloat16 in the program's place)."""
