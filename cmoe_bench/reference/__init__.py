"""The plain reference: the GP ensemble, its hyperparameter posterior and
the recommendation in plain PyTorch, written from the methods'
definitions.  It imports nothing of the port and takes nothing the port
derived: it standardizes, pads and factors the data itself."""
