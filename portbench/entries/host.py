"""The corpus handed to ``match`` as host bytes, unpadded, as a library
caller holding bytes hands it."""

from portbench import workload


class Entry(workload.Entry):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.host = self.text[: self.n].cpu().numpy().tobytes()

    def warm(self) -> None:
        """Every item's matchers built as ``match`` builds them, and two
        whole calls: every call stages the same shapes."""
        for k in range(len(self.items)):
            self.matcher(k)
        for k in range(min(2, len(self.items))):
            self.query(k)

    def query(self, k: int) -> list:
        items = self.items[k]
        out = self.port.match(self.host,
                              list(items) if self.multi else items[0],
                              algo=self.algo, config=self.cfg,
                              device=self.device)
        return workload.answers(out if self.multi else [out])
