from .registry import (SCENARIOS, Scenario, get_scenario, list_scenarios,
                       register)

__all__ = ["SCENARIOS", "Scenario", "get_scenario", "list_scenarios",
           "register"]
