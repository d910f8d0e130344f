"""The sharded runtime on ``torch.distributed``, one rank per shard (port of
clid_slam_tpu/parallel): the data-parallel mapper (``data_parallel``) and
the spatially sharded map with its query, mapping and tracker
(``spatial``), over the rank-ordered collectives of ``collectives``."""
