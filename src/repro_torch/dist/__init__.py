"""Distribution (the reference's ``repro/dist``): logical-axis sharding
rules and the mesh context on a torch ``DeviceMesh``, and the
collectives of the data-parallel train step."""
from .collectives import DataParallel
from .sharding import (
    PROFILES,
    MeshContext,
    NamedSharding,
    ShardingProfile,
    current_context,
    current_mesh,
    dp_vocab,
    get_profile,
    logical_to_pspec,
    moe_ep,
    param_shardings,
    profile_names,
    register_profile,
    tp_dp,
    tp_fsdp,
    use_mesh_context,
)

__all__ = [
    "PROFILES",
    "DataParallel",
    "MeshContext",
    "NamedSharding",
    "ShardingProfile",
    "current_context",
    "current_mesh",
    "dp_vocab",
    "get_profile",
    "logical_to_pspec",
    "moe_ep",
    "param_shardings",
    "profile_names",
    "register_profile",
    "tp_dp",
    "tp_fsdp",
    "use_mesh_context",
]
