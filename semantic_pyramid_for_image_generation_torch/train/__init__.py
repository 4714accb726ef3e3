"""The eval-mode generate function (the train step joins with the training slice)."""
