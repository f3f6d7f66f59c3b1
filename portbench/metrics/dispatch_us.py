"""The host's time from entering the program's reduce_fn to its return
(before the synchronise), averaged over the slice's calls, in
microseconds, by the benchmark's own host clock."""


def read(s):
    if not s.dispatch_s:
        return None
    return sum(s.dispatch_s) / len(s.dispatch_s) * 1e6
