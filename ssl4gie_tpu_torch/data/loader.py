"""Host-side sample sources (the `Source` base of `ssl4gie_tpu/data/
loader.py`). The loaders, prefetch and the other sources are not ported
yet."""

from __future__ import annotations


class Source:
    """Indexable sample source yielding dicts of numpy arrays."""

    def __len__(self):
        raise NotImplementedError

    def get(self, index: int) -> dict:
        raise NotImplementedError
