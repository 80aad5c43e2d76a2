"""The sharded engine (port of vbx_tpu.parallel): a ('dp', 'sp') mesh of
torch devices in one process, the frame-sharded forward-backward
smoothers, and the sharded VB-HMM engine. Recordings run data-parallel
over 'dp'; the frames of one recording run sequence-parallel over 'sp',
the long-recording path.

parallel.distributed joins the processes of a multi-host corpus run (a
gloo process group: `initialize`, `local_recording_slice`, `barrier`), and
parallel.dryrun holds the mesh engine, its kernel route, the checkpointed
engine and the service to their one-device answers on n devices.
"""

from vbx_tpu_torch.parallel.engine import ShardedVBxResult, vbx_sharded
from vbx_tpu_torch.parallel.fb_blockwise import (
    forward_backward_blockwise, forward_backward_blockwise_kernel)
from vbx_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "forward_backward_blockwise",
           "forward_backward_blockwise_kernel", "vbx_sharded",
           "ShardedVBxResult"]
