"""Guest emulator: host time interpreting guest code per batched entry
call, in ms.  The program's ``emulator`` spans are inclusive (they hold the
crossings the guest makes), so each thread's guest time is the union of
its emulator spans less the part its crossing spans cover.  Read in the
traced half of the window."""
from portbench.devtrace import union


def _overlap(xs, ys):
    total, j = 0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += min(b, ys[k][1]) - max(a, ys[k][0])
            k += 1
    return total


def read(record):
    batches = record["traced_counters"]["batches"]
    by_tid: dict = {}
    for s in record["spans"]:
        if s.kind in ("emulator", "crossing") and s.dur_ns:
            by_tid.setdefault(s.tid, {"emulator": [], "crossing": []})[s.kind].append(
                (s.start_ns, s.start_ns + s.dur_ns))
    if not batches or not by_tid:
        return None
    guest_ns = 0
    for kinds in by_tid.values():
        emu, cross = union(kinds["emulator"]), union(kinds["crossing"])
        guest_ns += sum(b - a for a, b in emu) - _overlap(emu, cross)
    return guest_ns / 1e6 / batches
