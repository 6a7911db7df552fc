"""Multi-device training: the collectives and the explicit parallel bodies."""
