"""The plain reference of PLAR's answers (plain PyTorch; nothing of the program).

:mod:`.plar` works every answer out again from the generated rows: the
granules, Θ(D|C), the core, the greedy reduct with its Θ history, and the
reduct service's warm repair.  :mod:`.compare` holds a run's answers against
it and gives each number compared with its limit.
"""
