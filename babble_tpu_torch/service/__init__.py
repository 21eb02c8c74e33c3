"""The node's service tier. Only the admission plane (ingress.py,
which Node builds when Config.admission is on) is ported; the HTTP
service waits for ROADMAP A7b."""
