"""Host ms a traced 3D step inside the union of the program's
``advchain.chain.*`` spans."""
from cudabench.spans import transforms_host_ms as read  # noqa: F401
