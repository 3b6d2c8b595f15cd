"""paddle.vision counterpart: the model zoo (`vision.models`). The
transforms, datasets and ops are not ported yet."""
from . import models  # noqa: F401
