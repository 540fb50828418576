"""Dev loop: state kept across a reload of the package, and a source-watching rerun."""

from housescan_tpu_torch.devloop.reload import (
    get_state,
    reload_framework,
    run_watched,
    store_state,
)

__all__ = ["get_state", "store_state", "reload_framework", "run_watched"]
