"""Communication layer, one process per rank: the world (``dist.py``),
topology and the 1-D ring (``mesh.py``), the RDMA kernels' peer memory
(``peer.py``), halo exchange and the hot-loop runners (``halo.py``),
collectives (``collectives.py``), ring and all-to-all attention at
world=1 (``ring.py``, ``alltoall.py``).
"""
