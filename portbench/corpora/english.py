"""Words drawn uniformly and independently from a fixed vocabulary, each
followed by one space: the word soup of the repository's ``gen_english``
(BASELINE configs 1-3)."""

import torch

from portbench import corpus

WORDS = (
    b"the quick brown fox jumps over lazy dog and cat with some very common "
    b"english words that repeat often in natural text corpus pattern match "
    b"string search algorithm parallel device memory vector lane tile shard"
).split()


def fill(out: torch.Tensor, n: int, g: torch.Generator) -> None:
    dev = out.device
    spelled = [w + b" " for w in WORDS]
    flat = torch.tensor(list(b"".join(spelled)), dtype=torch.uint8, device=dev)
    lens = torch.tensor([len(s) for s in spelled], dtype=torch.int64,
                        device=dev)
    base = torch.cumsum(lens, 0) - lens
    mean = sum(len(s) for s in spelled) / len(spelled)
    # 2% more words than the mean needs: the sum of ~n/6 lengths strays
    # from its mean by ~sqrt(n/6) * 2.4 bytes, far less.
    count = int(n / mean * 1.02) + 1024
    idx = torch.randint(0, len(WORDS), (count,), generator=g, device=dev)
    ln = lens[idx]
    ends = torch.cumsum(ln, 0)
    if int(ends[-1]) < n:
        raise RuntimeError("english: too few words drawn")
    # Byte p lies in word w (ends[w-1] <= p < ends[w]) at p - (ends[w] -
    # ln[w]); its byte is flat[base[idx[w]] + that].
    shift = base[idx] - (ends - ln)
    for a in range(0, n, corpus.CHUNK):
        p = torch.arange(a, min(a + corpus.CHUNK, n), device=dev)
        w = torch.searchsorted(ends, p, right=True)
        out[a : a + p.numel()] = flat[shift[w] + p]
