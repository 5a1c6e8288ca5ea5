"""MyoSuite in JAX: muscle-tendon physics, batched task envs, on-device learners."""
