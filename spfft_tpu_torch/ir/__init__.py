"""spfft_tpu_torch.ir: the stage-graph IR of the local engines.

1. **Graph** (:mod:`.graph`): a typed stage graph whose nodes carry the
   canonical stage labels (:data:`NODES`), validated before anything runs.
2. **Lowering** (:mod:`.lower`): the two local engines describe each
   direction of their pipeline as a stage graph built from their stage bodies.
3. **Compile** (:mod:`.compile`): a graph runs fused (one program per
   direction; on the card one CUDA-graph replay), staged (one call per node,
   ``SPFFT_TPU_FUSE=0`` or ``fuse=False``), or batched (B requests of one plan
   in one program, ``SPFFT_TPU_BATCH_FUSE``).
"""
from .compile import (  # noqa: F401
    BATCH_FUSE_ENV,
    BATCH_KEYS,
    FUSE_ENV,
    IR_KEYS,
    EngineIr,
    StagedProgram,
    compose,
    dispatches,
    init_engine_ir,
    resolve_batch_fuse,
    resolve_fuse,
)
from .graph import NODES, EdgeMeta, Node, StageGraph  # noqa: F401
from .lower import lower_engine  # noqa: F401
