"""Multi-agent soccer (counterpart of ``dm_control_tpu/locomotion/soccer/``):
``load`` runs a match of BoxHead, ant or humanoid players through
``composer.Environment`` on the host, ``load_batch`` steps thousands of
BoxHead matches on the device, one reward per player.
``MultiplayerTrackingCamera`` (``Task(tracking_cameras=...)``) follows a
match and renders it on the physics' device."""

from dm_control_torch.locomotion.soccer.boxhead import BoxHead  # noqa: F401
from dm_control_torch.locomotion.soccer.camera import (  # noqa: F401
    MultiplayerTrackingCamera,
)
from dm_control_torch.locomotion.soccer.humanoid import Humanoid  # noqa: F401
from dm_control_torch.locomotion.soccer.initializers import (  # noqa: F401
    Initializer, UniformInitializer,
)
from dm_control_torch.locomotion.soccer.loader import (  # noqa: F401
    WalkerType, load, load_batch,
)
from dm_control_torch.locomotion.soccer.observables import (  # noqa: F401
    CoreObservablesAdder, InterceptionObservablesAdder,
    MultiObservablesAdder, ObservablesAdder,
)
from dm_control_torch.locomotion.soccer.pitch import (  # noqa: F401
    MINI_FOOTBALL_GOAL_SIZE, MINI_FOOTBALL_MAX_AREA_PER_HUMANOID,
    MINI_FOOTBALL_MIN_AREA_PER_HUMANOID, Pitch, RandomizedPitch,
)
from dm_control_torch.locomotion.soccer.soccer_ball import (  # noqa: F401
    SoccerBall, regulation_soccer_ball,
)
from dm_control_torch.locomotion.soccer.task import (  # noqa: F401
    MultiturnTask, Task,
)
from dm_control_torch.locomotion.soccer.team import (  # noqa: F401
    RGBA_BLUE, RGBA_RED, Player, Team,
)
