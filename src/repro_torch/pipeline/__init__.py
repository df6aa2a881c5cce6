"""Job engine: ``plan`` types a method as stage descriptions, ``stages`` holds
the shared stage implementations, ``executor`` runs a plan on one device."""
