"""The benchmark's traffic generators: frozen copies of the program's
synthetic world, feature-level source, renderer and TUM writer."""
