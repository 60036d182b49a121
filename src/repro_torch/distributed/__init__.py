"""The distribution layer of the port on ``torch.distributed``
(counterpart of ``repro.distributed``): sharding rules as specs over a
named ``DeviceMesh`` and their DTensor placements (``sharding``), the
ambient mesh and ``constrain`` for model code (``constraints``), the
sequence-sharded decode's LSE combine across ranks (``collectives``),
re-placement on another mesh (``elastic``), and the restart supervisor of
``launch/train.py`` (``fault_tolerance``)."""
from repro_torch.distributed.sharding import (P, batch_axes, cache_pspecs,  # noqa: F401
                                              choose_mode, data_pspecs, opt_pspecs,
                                              param_pspecs, to_placements)
from repro_torch.distributed.fault_tolerance import (FailureDetector,  # noqa: F401
                                                     HostFailure, StragglerMonitor,
                                                     TrainingSupervisor)
from repro_torch.distributed.elastic import replace_on_mesh, validate_divisibility  # noqa: F401
