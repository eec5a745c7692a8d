"""reshard/ — checkpoints that move between meshes: the port of the JAX
`reshard` package.

* `layout`: the Layout record (mesh axes, each leaf's canonical spec, the
  ZeRO stage) every rank file carries as its `__layout__` stamp;
* `plan`: the redistribution pass, leaf by leaf (file fragments, device
  op, bytes moved), host numpy only;
* `apply`: the streamed executors, file → file (`reshard_checkpoint`) and
  file → this rank (`stream_load`), and a live model → another tp width
  (`reshard_params`), one leaf at a time;
* `reshard_ckpt`: the offline CLI.
"""

from .apply import (HostMeter, live_plan, plan_checkpoint,
                    reshard_checkpoint, reshard_params, stream_load)
from .layout import (LAYOUT_KEY, Layout, layouts_equal, make_layout,
                     read_stamp, resolve_source_layout)
from .plan import LeafPlan, ReshardError, ReshardPlan, plan_reshard

__all__ = [
    "LAYOUT_KEY", "Layout", "layouts_equal", "make_layout", "read_stamp",
    "resolve_source_layout", "LeafPlan", "ReshardError", "ReshardPlan",
    "plan_reshard", "HostMeter", "plan_checkpoint", "reshard_checkpoint",
    "stream_load", "reshard_params", "live_plan",
]
