"""Multi-device retrieval of the port: the corpus mesh and the sharded scan
(``torch.distributed``, one process per device)."""

from .mesh import corpus_mesh, replicate, shard_rows
from .sharded_index import shard_corpus, sharded_topk

__all__ = ["corpus_mesh", "shard_rows", "replicate", "sharded_topk", "shard_corpus"]
