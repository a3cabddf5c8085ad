"""Launch tools: the production meshes, ``build_combo`` and the dry run
(port of the JAX package's ``launch/``).  ``dryrun`` is an entry point
(``python -m repro_torch.launch.dryrun``) and is not imported here."""
from .mesh import make_host_mesh, make_production_mesh  # noqa: F401
