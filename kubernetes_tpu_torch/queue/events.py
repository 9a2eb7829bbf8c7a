"""Named cluster events that wake unschedulable pods
(``kubernetes_tpu/queue/events.py``; internal/queue/events.go:25-91), the
subset the scheduler loop fires."""

from ..framework.types import (ADD, ALL, ClusterEvent, DELETE, NODE, POD,
                               UPDATE_NODE_ALLOCATABLE, UPDATE_NODE_CONDITION,
                               UPDATE_NODE_LABEL, UPDATE_NODE_TAINT, WILDCARD)

UNSCHEDULABLE_TIMEOUT = ClusterEvent(WILDCARD, ALL, "UnschedulableTimeout")
NODE_ADD = ClusterEvent(NODE, ADD, "NodeAdd")
POD_ADD = ClusterEvent(POD, ADD, "PodAdd")
POD_DELETE = ClusterEvent(POD, DELETE, "AssignedPodDelete")
EVICTION = ClusterEvent(POD, DELETE, "EvictionWave")
# a peer scheduler's session fenced on the shared device service: its
# capacity was released, like an assigned pod's delete (the wire path)
SCHEDULER_TAKEOVER = ClusterEvent(POD, DELETE, "SchedulerTakeover")
NODE_ALLOCATABLE_CHANGE = ClusterEvent(NODE, UPDATE_NODE_ALLOCATABLE, "NodeAllocatableChange")
NODE_LABEL_CHANGE = ClusterEvent(NODE, UPDATE_NODE_LABEL, "NodeLabelChange")
NODE_TAINT_CHANGE = ClusterEvent(NODE, UPDATE_NODE_TAINT, "NodeTaintChange")
NODE_CONDITION_CHANGE = ClusterEvent(NODE, UPDATE_NODE_CONDITION, "NodeConditionChange")
