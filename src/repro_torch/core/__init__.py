"""Core engine layer: events, queues, operators, workflow, updater paths."""
