"""The paper's contribution: adaptive split inference with activation
compression over a simulated AI-RAN network.  The names of
``repro/core/__init__.py``, from the port's modules."""
from repro_torch.core.compression import ActivationCodec, CompressedPayload  # noqa: F401
from repro_torch.core.splitting import (SplitPlan, SwinSplitPlan, LMSplitPlan,  # noqa: F401
                                        Workload, UE_ONLY, SERVER_ONLY,
                                        split_option)
from repro_torch.core.cell import (CellSimulator, TailBatcher, CellStats,    # noqa: F401
                                   cell_interference_traces)
from repro_torch.core.ran import (RanCell, RanConfig, MultiCell,             # noqa: F401
                                  SchedulerPolicy, RoundRobinScheduler,
                                  ProportionalFairScheduler,
                                  DeadlineEDFScheduler, make_policy,
                                  jain_fairness)
from repro_torch.core.mobility import (MobilityModel, MobilityConfig,        # noqa: F401
                                       CellSite, StaticTrajectory,
                                       WaypointTrajectory,
                                       RandomWaypointTrajectory,
                                       static_mobility, two_cell_sites)
from repro_torch.core.channel import (ChannelModel, PathModel, dupf_path,    # noqa: F401
                                      cupf_path, INTERFERENCE_LEVELS)
from repro_torch.core.calibration import calibrate, Calibrated, PAPER        # noqa: F401
from repro_torch.core.adaptive import AdaptiveController, Objective          # noqa: F401
from repro_torch.core.pipeline import (SplitInferencePipeline,               # noqa: F401
                                       build_pipeline, FrameSource)
from repro_torch.core.timeline import EdgeQueue, run_stream                  # noqa: F401
