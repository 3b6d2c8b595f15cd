"""paddle.vision counterpart: the model zoo (`vision.models`) and the
detection and image ops (`vision.ops`). The transforms and datasets are
not ported yet."""
from . import models  # noqa: F401
from . import ops  # noqa: F401
