"""The plain reference of the benchmark's cells: the env, the nets, the
replay draws and each agent's train step in plain PyTorch and NumPy. It
imports neither JAX nor the JAX package nor the program under test; the
train-step driver finds an agent's reference as `reference/<agent>.py`,
whose `Reference` class follows a run from its seed and initial weights,
whose `shapes` gives the weights' names, shapes and kinds, and whose
`schedule`, where it has one, gives the first step that learns and the
steps until the agent's state has filled."""
