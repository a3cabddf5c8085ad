from .store import exists, load_metadata, restore, save  # noqa: F401
from .lifecycle import (  # noqa: F401
    lifecycle_reference,
    lifecycle_tree,
    restore_lifecycle,
    save_lifecycle,
)
