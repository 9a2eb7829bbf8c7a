"""Pod admission on the store's create path: DefaultPriority.

An own copy of the one plugin of ``kubernetes_tpu/apiserver/admission.py``
(``:79-94``; plugin/pkg/admission/priority) that can change a placement
the port makes from the pod alone: a pod that names a PriorityClass and
sets no priority gets the class's value, and a pod naming a class the
store does not hold is refused. ``Store.create_pod`` runs it before the
write and before the handlers, as the JAX store runs its chain. The JAX
chain's other plugins are not ported (ROADMAP.md lists them).
"""

from __future__ import annotations


class AdmissionError(Exception):
    """403: an admission plugin refused the write."""

    def __init__(self, plugin: str, message: str):
        super().__init__(f"admission denied by {plugin}: {message}")
        self.plugin = plugin


class DefaultPriority:
    """Resolve ``priorityClassName`` to ``spec.priority`` at create."""

    name = "Priority"

    def admit(self, store, pod) -> None:
        if pod.spec.priority_class_name and not pod.spec.priority:
            pc = store.priority_classes.get(pod.spec.priority_class_name)
            if pc is None:
                raise AdmissionError(
                    self.name, f"no PriorityClass {pod.spec.priority_class_name!r}")
            pod.spec.priority = pc.value
