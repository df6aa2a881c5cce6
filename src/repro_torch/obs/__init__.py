"""Observability: span tracing and the job-counter policy (main-path parts)."""
