"""Model architectures as selectable configs (mirror of ``repro.configs``)."""

from repro_torch.configs.registry import (  # noqa: F401
    get_config,
    list_archs,
    reduced_config,
)
