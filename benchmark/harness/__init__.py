"""The benchmark's shared code: the scene and its caches, the device and
its profile, and the arithmetic the metric readers share."""
