"""``torch.func``'s forward-mode transforms, one thread at a time.

``torch.func.jvp`` (under ``jacfwd`` and ``hessian``) keeps its nesting
depth in a module global and forward AD its dual level process-wide, so
two threads inside forward-mode transforms at once corrupt each other's
derivatives; the shards of a sharded call (``parallel``) run in threads of
their own.  The port takes ``jacfwd`` and ``hessian`` from here: each call
of a transformed function runs under one reentrant lock.  ``vmap``,
``grad`` and ``jacrev`` keep their state per thread and need none.
"""

import functools
import threading

import torch.func

_lock = threading.RLock()


def _one_thread_at_a_time(transform):
    @functools.wraps(transform)
    def wrapped(func, *args, **kwargs):
        inner = transform(func, *args, **kwargs)

        @functools.wraps(inner)
        def run(*a, **k):
            with _lock:
                return inner(*a, **k)

        return run

    return wrapped


jacfwd = _one_thread_at_a_time(torch.func.jacfwd)
hessian = _one_thread_at_a_time(torch.func.hessian)
