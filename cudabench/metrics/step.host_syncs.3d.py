"""The port's ``host_syncs`` counter a traced 3D step, where it equals the
trace's synchronising calls inside ``advchain.step``."""
from cudabench.spans import host_syncs as read  # noqa: F401
