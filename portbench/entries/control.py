"""The control: the reference in the port's place, weakened.  It compares
only the first bytes of each pattern (``reference.truncated``) and
answers from a cache once it has worked an item out.  The check has to
find it not correct; the benchmark's own runs never take it."""

from portbench import reference, workload


class Entry(workload.Entry):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.cache = {}

    def query(self, k: int) -> list:
        if k not in self.cache:
            cap = self.cfg.capacity
            out = []
            for pat in self.items[k]:
                offs = reference.find_all(self.text, self.n, pat,
                                          reference.truncated(len(pat)))
                out.append(workload.Answer(pat, len(offs), offs[:cap],
                                           len(offs) > cap))
            self.cache[k] = out
        return self.cache[k]
