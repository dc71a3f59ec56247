"""Quickstart on the PyTorch port: the paper's running example + a first
real index (examples/quickstart.py's flow and lines, on the card unless
``--device cpu``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import alphabet as al
from repro_torch.core.bwt import bwt
from repro_torch.core.fm_index import PAD
from repro_torch.core.pipeline import build_index
from repro_torch.devices import resolve_device


def banana(device):
    """Figures 1-2 of the paper: S = BANANA$.

    The paper's figure sorts '$' as the LARGEST symbol (giving BNN$AAA,
    I=3); we use the modern FM-index convention '$' smallest, giving the
    equally valid BWT ANNB$AA, I=4 — same rotation multiset, and the
    inverse transform recovers BANANA$ either way.
    """
    s = al.append_sentinel(al.encode_str("BANANA"))
    sigma = al.sigma_of(s)
    b, row = bwt(torch.as_tensor(s, device=device), sigma)
    shown = "".join(
        "$" if t == al.SENTINEL else chr(t - 1) for t in b.tolist()
    )
    print(f"bwt(BANANA$) = {shown}   I = {int(row)}   "
          f"(paper, $-largest convention: BNN$AAA, I=3)")
    assert shown == "ANNB$AA" and int(row) == 4


def first_index(device):
    rng = np.random.default_rng(0)
    text = rng.integers(1, 5, 5000).astype(np.int32)  # DNA-ish tokens 1..4
    index = build_index(text, sample_rate=64, device=device)

    queries = np.full((3, 8), PAD, np.int32)
    queries[0, :3] = text[100:103]     # guaranteed hit
    queries[1, :6] = text[2000:2006]   # guaranteed hit
    queries[2, :4] = [1, 1, 1, 1]      # maybe
    counts = index.count(queries).cpu().numpy()
    print(f"indexed {len(text)} tokens; query counts = {counts.tolist()}")
    assert counts[0] >= 1 and counts[1] >= 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    banana(device)
    first_index(device)
    print("quickstart OK")


if __name__ == "__main__":
    main()
