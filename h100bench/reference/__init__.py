"""The benchmark's plain reference, which imports nothing of the program.

``gridworld``: a batch of lockstep gridworlds written straight from their
rules (MAgent's agent types, ranges, actions, views and reward rules, and
the lockstep step: attacks in a random priority order per target, moves
resolved all at once), on whole grids with plain tensor operations.
``threefry``: the Threefry-2x32 keys and draws of ``jax.random``'s
definition, in NumPy.  ``dqn``: the net, its TD loss and clipped Adam in
plain float32 operations."""
