"""The host-axis sharded engine on ``torch.distributed`` (port of
``shard/``): ``engine.ShardedEngine`` runs one experiment over the ranks
of a world, ``launch`` starts ranks for the tools and the tests."""

from shadow1_tpu_torch.shard.engine import ShardedEngine

__all__ = ["ShardedEngine"]
