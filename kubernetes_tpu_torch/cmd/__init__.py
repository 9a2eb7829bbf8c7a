"""Component binaries (the cmd/* layer; an own copy of
``kubernetes_tpu/cmd/``): the scheduler and API server entry points with the
component-base serving surface (healthz/readyz/configz/metrics mux, leader
election, feature gates).
"""
