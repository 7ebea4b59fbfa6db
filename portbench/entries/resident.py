"""The corpus stays on the card, padded once as ``match`` pads it; each
query is the matcher's ``run`` and the results assembled on the host."""

from portbench import workload


class Entry(workload.Entry):
    def query(self, k: int) -> list:
        m, n, make_result = self.matcher(k), self.n, self.base.make_result
        if self.multi:
            return workload.answers([make_result(m.name, pat, n, *t)
                                     for pat, t in zip(m.patterns,
                                                       m.run(self.text, n))])
        return workload.answers([make_result(m.name, m.pattern_bytes, n,
                                             *m.run(self.text, n))])
