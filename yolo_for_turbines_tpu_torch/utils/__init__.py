from .debug import checked_loss, debug_nans, debug_nans_scope
from .seed import seed_everything
