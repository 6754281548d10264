"""The serving system: estimator, scheduler, resource table, metadata
buffer, server config and the ``BulletServer`` engine."""
