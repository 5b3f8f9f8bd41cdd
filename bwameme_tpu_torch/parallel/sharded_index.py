"""A suffix-array search over an index sharded by rank blocks.

Port of bwameme_tpu/parallel/sharded_index.py. There the big per-suffix
planes are split over the ``idx`` axis of a mesh and every probe is
answered by the owning shard, the shards' masked rows combined with one
psum (``owned``, :137-146). Here the planes are split into blocks over a
list of devices (index/device.py ``ShardedPlane``, a device may repeat), and
``make_sharded_search`` returns the search as the sharded seeding kernel
runs it on the card (csrc/seed_smem.cu built with SEED_SHARDED: a warp a
job reads each rank's row from the block that owns it, through the planes'
block table), or as its plain version runs it on the CPU (the owned gather
of ops/sa_search.py, the JAX package's sum of masked rows). The results are
those of the search over the whole index.
"""

from __future__ import annotations

import dataclasses

from bwameme_tpu_torch.index.device import DeviceIndex


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """The device index with its per-suffix planes in rank blocks (ktext in
    text-position blocks), the rest copied to every distinct device (the
    view of the first device's, DeviceIndex.on)."""

    di: DeviceIndex

    @staticmethod
    def shard(idx, devices) -> "ShardedIndex":
        """``idx`` (a MemeIndex, with the inverse suffix array, as the JAX
        package's ShardedIndex.shard asks) over ``devices``, in the layout
        the ladder picks for the blocks of the fullest card."""
        if idx.isa is None:
            raise ValueError("sharded search requires the MODE-3 ISA "
                             "(build_index(with_isa=True))")
        devices = list(devices)
        return ShardedIndex(DeviceIndex.from_host(
            idx, devices[0], shards=devices))

    @property
    def n_shards(self) -> int:
        return len(self.di.shards)


def make_sharded_search(si: ShardedIndex):
    """sa_query(qbuf32, row, pivot, v, min_intv) -> (mlen, lb, cnt) over the
    sharded index: the packed queries (rows, W) as int32 storage of uint32
    words and the (n,) int32 jobs on the index's first device. On a card it
    launches the sharded sa_query kernel, on the CPU its plain version."""
    from bwameme_tpu_torch.ops import seed_smem, seed_smem_cuda

    def sa_query(qbuf32, row, pivot, v, min_intv):
        args = (si.di, qbuf32, row, pivot, v, min_intv)
        out = (seed_smem_cuda.sa_query(*args) if seed_smem._on_cuda(qbuf32)
               else seed_smem.sa_query_torch(*args))
        return out[0], out[1], out[2]

    return sa_query

