"""Device idle ms a traced 3D step inside the program's
``advchain.solver.episode`` span."""
from cudabench.spans import solver_idle_ms as read  # noqa: F401
