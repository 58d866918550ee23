"""Sharded replay (the JAX package's ``replay/``): per-example records on a
self-describing wire (``wire.py``), per-shard ring or reservoir stores
(``store.py``), uniform or prioritized draws (``sampling.py``), the service
with its batched sampling front end (``service.py``), a stdlib HTTP door
(``frontend.py``), retrying clients (``client.py``) and the learner's feed
(``feed.py``). ``python -m tensor2robot_tpu_torch.replay.run_replay`` is the
entry point. Nothing here touches a card.
"""

from tensor2robot_tpu_torch.replay.client import (
    LocalReplayClient,
    ReplayClient,
    ReplayUnavailable,
)
from tensor2robot_tpu_torch.replay.feed import (
    ReplayBatchIterator,
    ReplayInputGenerator,
)
from tensor2robot_tpu_torch.replay.sampling import (
    POLICIES,
    PrioritizedPolicy,
    SamplePolicy,
    UniformPolicy,
    make_policy,
)
from tensor2robot_tpu_torch.replay.service import (
    REPLAY_RECORD_KIND,
    REPLAY_RECORD_SCHEMA,
    ReplayConfig,
    ReplayEmpty,
    ReplayService,
    SampleBatch,
)
from tensor2robot_tpu_torch.replay.store import RETENTIONS, ShardStore
from tensor2robot_tpu_torch.replay.wire import (
    ReplayWireError,
    assemble_batch,
    decode_example,
    encode_example,
    split_batch,
)

__all__ = [
    'LocalReplayClient',
    'POLICIES',
    'PrioritizedPolicy',
    'REPLAY_RECORD_KIND',
    'REPLAY_RECORD_SCHEMA',
    'RETENTIONS',
    'ReplayBatchIterator',
    'ReplayClient',
    'ReplayConfig',
    'ReplayEmpty',
    'ReplayInputGenerator',
    'ReplayService',
    'ReplayUnavailable',
    'ReplayWireError',
    'SampleBatch',
    'SamplePolicy',
    'ShardStore',
    'UniformPolicy',
    'assemble_batch',
    'decode_example',
    'encode_example',
    'make_policy',
    'split_batch',
]
