"""The part of the learned index that lives on the device.

In this slice only the packed reference text is needed there: extension
jobs are shipped as coordinates and the kernel decodes its target windows
from the text itself. The suffix-array and P-RMI planes follow with device
seeding. The same numpy ``MemeIndex`` (bwameme_tpu/index/build.py) feeds
the JAX package and this port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DeviceText:
    """``MemeIndex.text32`` on a device: uint32 words of the text plus its
    reverse complement, 16 bases per word, most significant bits first,
    followed by 12 all-T guard words; held as an int32 view (torch has no
    uint32 arithmetic)."""

    text32: torch.Tensor

    @classmethod
    def from_host(cls, idx, device) -> "DeviceText":
        # copy: a loaded index memory-maps its planes read-only
        words = np.array(idx.text32, dtype=np.uint32).view(np.int32)
        return cls(torch.from_numpy(words).to(torch.device(device)))

    @property
    def device(self) -> torch.device:
        return self.text32.device
