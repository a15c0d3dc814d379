"""Communication layer, one process per rank: the world (``dist.py``),
topology and the 1-D ring (``mesh.py``), the RDMA kernels' peer memory
(``peer.py``), halo exchange and the hot-loop runners (``halo.py``),
collectives (``collectives.py``), ring and all-to-all attention
(``ring.py``, ``alltoall.py``), host and link classes with the spans'
link stamps (``topology.py``), MoE token routing (``moe.py``) and the
sharded embedding (``embedding.py``).
"""
