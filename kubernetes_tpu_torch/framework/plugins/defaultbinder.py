"""DefaultBinder (defaultbinder/default_binder.go): the pod's binding
through the store. An own copy of ``kubernetes_tpu/framework/plugins/
defaultbinder.py``. The scheduler loop binds a committed batch through the
store's ``bind_batch`` in one pass; the plugin keeps the Bind point of the
profile, which the loop's bind tail requires to be this plugin alone."""

from __future__ import annotations

from typing import Optional

from ...api.types import Pod
from . import names


class DefaultBinder:
    def __init__(self, client=None):
        self.client = client

    def name(self) -> str:
        return names.DEFAULT_BINDER

    def bind(self, state, pod: Pod, node_name: str) -> Optional[str]:
        try:
            self.client.bind(pod.key(), node_name)
        except Exception as err:  # noqa: BLE001 - the status's error, as AsStatus(err)
            return str(err)
        return None
