"""Client runtime (the L3 layer, staging/src/k8s.io/client-go; an own copy
of ``kubernetes_tpu/client/``): reflector + DeltaFIFO + shared informers,
workqueue, leader election, over the port's ``apiserver/store.py:Store``.

A Reflector LISTs then WATCHes one kind, feeds a DeltaFIFO, and a
SharedIndexInformer pops deltas into an indexed local cache while fanning
out to event handlers. ``rest.APIClient`` is the store-shaped read path
over the HTTP front (``apiserver/http.py``): the same informers run over it.
"""

from .delta_fifo import Delta, DeltaFIFO
from .informer import SharedIndexInformer, SharedInformerFactory
from .leaderelection import LeaderElector
from .reflector import Reflector
from .workqueue import RateLimitingQueue, parallelize_until

__all__ = [
    "Delta",
    "DeltaFIFO",
    "LeaderElector",
    "RateLimitingQueue",
    "Reflector",
    "SharedIndexInformer",
    "SharedInformerFactory",
    "parallelize_until",
]
